"""Decode loops, the continuous-batching engine and calibration-stat
merging over the port's models."""
from .generate import (beam_search, decode_calibration, generate,
                       generate_kv, generate_speculative)
from .serialization import merge_calibration_stats
from .serving import ContinuousBatcher

__all__ = ["ContinuousBatcher", "beam_search", "decode_calibration",
           "generate", "generate_kv", "generate_speculative",
           "merge_calibration_stats"]
