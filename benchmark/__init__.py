"""The benchmark of numpy_quant_tpu_torch on an NVIDIA GPU (see run.py)."""
