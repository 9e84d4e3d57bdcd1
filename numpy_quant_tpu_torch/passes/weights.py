"""Weight-storage pass: packed sub-byte weights (port of
``numpy_quant_tpu/passes/weights.py::pack_weights``, without the
tensor-parallel stacked layout)."""
from __future__ import annotations

from ..graph import Constant, only_rhs_of
from ..tensor import QTensor, pack_qtensor


def pack_weights(model) -> int:
    """Switch every 2-D, symmetric, <= 8-bit quantized constant consumed
    only as a MatMul rhs to packed storage (kernels/pack.py: split-K at
    bits 1/2/4/8, bit-planes at odd widths), exactly bit_width bits per
    value. Returns the number of weights packed."""
    packed = 0
    for value in model.values:
        if not isinstance(value, Constant) \
                or not isinstance(value.data, QTensor):
            continue
        qt = value.data
        if qt.zero_point is not None or qt.data.ndim != 2 \
                or qt.bit_width > 8 or not only_rhs_of(value, ("MatMul",)):
            continue
        value.data = pack_qtensor(qt)
        packed += 1
    model.invalidate_params()
    return packed
