"""Calibration-stat helpers (port of the part of
``numpy_quant_tpu/utils/serialization.py`` the decode path needs)."""
from __future__ import annotations

import numpy as np


def merge_calibration_stats(*stats_dicts: dict) -> dict:
    """Merge {value name: (min, max)} dicts from several calibration
    batches into one running global min/max (the reductions are
    associative, so batch-at-a-time calibration equals one big batch:
    the reference's global reduction)."""
    merged: dict = {}
    for stats in stats_dicts:
        for name, (mn, mx) in stats.items():
            if name in merged:
                omn, omx = merged[name]
                merged[name] = (np.minimum(omn, mn), np.maximum(omx, mx))
            else:
                merged[name] = (np.float32(mn), np.float32(mx))
    return merged
