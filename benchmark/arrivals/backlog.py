"""A closed backlog: the mix's ``pool`` requests, all due when the window
opens; the loop keeps ``queue`` of them waiting and sends the next as
requests finish."""
import numpy as np


def due(mix: dict, shape: np.random.Generator, order: np.random.Generator,
        seconds: float) -> np.ndarray:
    return np.zeros(int(mix["pool"]), dtype=np.float64)
