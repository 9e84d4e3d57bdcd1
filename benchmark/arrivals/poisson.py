"""Open-loop Poisson arrivals at the mix's ``rate`` per second: the
inter-arrival gaps are drawn from the mix's shape seed until the window
is full, and the run seed only orders them (within blocks of the mix's
``order_block`` arrivals), so every seed sends the same number of
requests over the same window, with its bursts where the blocks put
them."""
import numpy as np

from benchmark.common import traffic


def due(mix: dict, shape: np.random.Generator, order: np.random.Generator,
        seconds: float) -> np.ndarray:
    rate = float(mix["rate"])
    gaps, t = [], 0.0
    while True:
        g = shape.exponential(1.0 / rate)
        if t + g >= seconds:
            break
        gaps.append(g)
        t += g
    gaps = np.asarray(gaps, dtype=np.float64)
    return np.cumsum(gaps[traffic.shuffled(order, gaps.size, mix)])
