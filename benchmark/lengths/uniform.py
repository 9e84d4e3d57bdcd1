"""Uniform lengths over ``min``..``max``, both included."""
import numpy as np


def draw(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(dist["min"], dist["max"] + 1, size=n)
