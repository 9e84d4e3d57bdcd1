"""Percentiles, rates and spreads over whole windows.

Every statistic here takes all the samples of a window: a tail is the tail
of all requests, a rate all the work over all the time. Nothing is taken
from medians of chunks."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values`` by linear
    interpolation between closest ranks (numpy's default). A value of
    ``inf`` (a request that failed) counts as larger than every other."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work per second over a whole window."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return count / seconds


def spread(values) -> float:
    """Inter-quartile distance over the median, as a share:
    ``statistics.quantiles(values, n=4)``'s first and third quartiles."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
