"""Lognormal lengths: ``median`` and ``sigma`` (of the log), rounded and
clipped to ``min``..``max``."""
import numpy as np


def draw(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    raw = np.exp(np.log(dist["median"]) + dist["sigma"]
                 * rng.standard_normal(n))
    return np.clip(np.rint(raw), dist["min"], dist["max"])
