"""Decode loops, the continuous-batching engine, calibration-stat merging,
QModel save/load and the standard-format (QDQ, QOperator) exports over the
port's models."""
from .generate import (beam_search, decode_calibration, generate,
                       generate_kv, generate_speculative)
from .serialization import (export_qdq, export_qoperator,
                            import_onnx_quantized, load_calibration_stats,
                            load_qmodel, load_weight_only,
                            merge_calibration_stats, save_calibration_stats,
                            save_qmodel, save_qmodel_qdq,
                            save_qmodel_qoperator, save_weight_only)
from .serving import ContinuousBatcher

__all__ = ["ContinuousBatcher", "beam_search", "decode_calibration",
           "export_qdq", "export_qoperator", "generate", "generate_kv",
           "generate_speculative", "import_onnx_quantized",
           "load_calibration_stats", "load_qmodel", "load_weight_only",
           "merge_calibration_stats", "save_calibration_stats",
           "save_qmodel", "save_qmodel_qdq", "save_qmodel_qoperator",
           "save_weight_only"]
