"""Every length ``value``."""
import numpy as np


def draw(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.full(n, dist["value"])
