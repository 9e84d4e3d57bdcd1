"""Decode loops over the port's models, and calibration-stat merging."""
from .generate import decode_calibration, generate_kv
from .serialization import merge_calibration_stats

__all__ = ["decode_calibration", "generate_kv", "merge_calibration_stats"]
