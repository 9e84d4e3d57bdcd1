"""Percentiles, rates and spreads against hand values."""
import math
import statistics

import pytest

from benchmark.common import stats


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 101))       # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([4, 1, 3, 2], 100) == 4


def test_failed_requests_count_as_missing_every_limit():
    xs = [1.0] * 90 + [math.inf] * 10
    assert stats.percentile(xs, 95) == math.inf
    assert stats.percentile(xs, 50) == 1.0


def test_rate_is_over_the_whole_window():
    assert stats.rate(2400, 1.2) == pytest.approx(2000.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)
