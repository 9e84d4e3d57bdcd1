"""numpy-quant-tpu-torch: the PyTorch/CUDA port of numpy_quant_tpu.

Imports static-shape ONNX graphs, calibrates min/max statistics,
quantizes with the reference's per-node strategy and executes the int8
graph on an NVIDIA GPU, with the fused attention block as a hand-written
CUDA kernel. Entry points run on CUDA unless the caller passes
``device="cpu"``. Imports no JAX and nothing of ``numpy_quant_tpu``.
"""
from . import config, onnx
from .graph import Constant, Node, Value, Variable
from .model import Model, QModel, QuantizationParams
from .quantization import (
    dequantize,
    int_matmul,
    q_matmul,
    quant_parameters,
    quantize,
    requantize,
)
from .tensor import (
    FTensor,
    ITensor,
    QTensor,
    Tensor,
    concat,
    fconv2d,
    quantize_tensor,
    quantize_tensor_min_max,
    tensor_min_max,
    where,
)

__version__ = "0.1.0"

__all__ = [
    "config", "onnx",
    "Model", "QModel", "QuantizationParams",
    "Constant", "Variable", "Node", "Value",
    "FTensor", "ITensor", "QTensor", "Tensor",
    "quant_parameters", "quantize", "dequantize", "q_matmul", "requantize",
    "int_matmul", "quantize_tensor", "quantize_tensor_min_max",
    "tensor_min_max", "concat", "where", "fconv2d",
]
