"""Decode loops, the continuous-batching engine, calibration-stat merging,
QModel save/load, the standard-format (QDQ, QOperator) exports and the
deployment artifacts (``torch.export`` programs) over the port's models;
the profiling, per-value parity, quantization-error and summary tools."""
from .analyzer import print_quantization_report, quantization_report
from .aot import (load_compiled, load_decode_loop, save_compiled,
                  save_decode_loop)
from .generate import (beam_search, decode_calibration, generate,
                       generate_kv, generate_mamba, generate_seq2seq,
                       generate_speculative, mamba_decode_calibration)
from .serialization import (export_qdq, export_qoperator,
                            import_onnx_quantized, load_calibration_stats,
                            load_qmodel, load_weight_only,
                            merge_calibration_stats, save_calibration_stats,
                            save_qmodel, save_qmodel_qdq,
                            save_qmodel_qoperator, save_weight_only)
from .parity import compare_all_values, record_all_values
from .profiling import (device_busy_seconds, device_trace,
                        profile_results_plot, summarize_device_trace)
from .serving import ContinuousBatcher
from .summary import summarize

__all__ = ["ContinuousBatcher", "beam_search", "compare_all_values",
           "decode_calibration", "device_busy_seconds", "device_trace",
           "export_qdq", "export_qoperator", "generate", "generate_kv",
           "generate_mamba", "generate_seq2seq", "generate_speculative",
           "import_onnx_quantized", "mamba_decode_calibration",
           "load_calibration_stats", "load_compiled", "load_decode_loop",
           "load_qmodel", "load_weight_only",
           "merge_calibration_stats", "print_quantization_report",
           "profile_results_plot", "quantization_report",
           "record_all_values", "save_calibration_stats", "save_compiled",
           "save_decode_loop", "save_qmodel",
           "save_qmodel_qdq", "save_qmodel_qoperator", "save_weight_only",
           "summarize", "summarize_device_trace"]
