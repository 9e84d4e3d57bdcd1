"""Global knobs for the PyTorch port.

Mirrors ``numpy_quant_tpu/config.py`` in TPU-mode numerics: the float
data plane is float32 (or bfloat16 under :class:`low_precision_floats`),
quantized payloads ride in int32 containers and are stored as int8 at
<= 8 bits, and scale math is float32.

Float matmuls and convolutions run in true float32: TF32 is switched off
for both cuBLAS and cuDNN (the cuDNN flag defaults to on), matching the
JAX float path's ``Precision.HIGHEST``.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Dtype of the float data plane (FTensor). bfloat16 is the serving mode.
float_dtype = torch.float32

# How a MatMul with a packed weight (PackedQTensor, QModel.pack_weights)
# executes:
#   "unpack" (default) -- unpack the payload to int8, then the int8
#             product of quantization.int_matmul (torch._int_mm on CUDA);
#   "kernel" -- the hand-written packed kernels (kernels/qmatmul.py:
#             splitk_qmatmul, packed_qmatmul) decode the payload tile by
#             tile and fuse the zero-point correction and dequantize.
packed_execution = "unpack"

# Model.__call__ on a CUDA model replays one captured CUDA graph per input
# signature; under eager_forward it walks the graph node by node instead
# (the counterpart of jax.disable_jit()).
eager = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    CUDA. Raises when CUDA was implied but no card is present -- the
    port never carries on silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return torch.device("cuda")


class low_precision_floats:
    """Context manager: run the float data plane in bfloat16."""

    def __enter__(self):
        global float_dtype
        self._prev = float_dtype
        float_dtype = torch.bfloat16
        return self

    def __exit__(self, *exc):
        global float_dtype
        float_dtype = self._prev
        return False


class eager_forward:
    """Context manager: ``Model.__call__`` walks the graph eagerly on CUDA
    too (no captured graph), without a host sync per node."""

    def __enter__(self):
        global eager
        self._prev = eager
        eager = True
        return self

    def __exit__(self, *exc):
        global eager
        eager = self._prev
        return False
