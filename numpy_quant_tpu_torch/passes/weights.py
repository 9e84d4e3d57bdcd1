"""Weight-storage passes: packed sub-byte weights (port of
``numpy_quant_tpu/passes/weights.py::pack_weights``, with the
tensor-parallel stacked layout), the integer-domain bias shift and the
float-constant rewrites the PTQ accuracy passes share."""
from __future__ import annotations

import numpy as np
import torch

from ..graph import Constant, only_rhs_of
from ..intops import qrange
from ..tensor import FTensor, QTensor, pack_qtensor


def _row_shards(model, name: str) -> int:
    """The model axis's size if the sharding rules row-(K-)shard this 2-D
    weight, else 1 (JAX ``passes/weights.py:32-45``)."""
    rules = getattr(model, "_shard_rules", None)
    mesh = getattr(model, "mesh", None)
    if mesh is None or rules is None:
        return 1
    m_ax = getattr(model, "model_axis", "model")
    if m_ax not in mesh.shape or mesh.shape[m_ax] < 2:
        return 1
    parts = tuple(rules(name, 2))
    if parts and parts[0] == m_ax and all(p is None for p in parts[1:]):
        return mesh.shape[m_ax]
    return 1


def pack_weights(model) -> int:
    """Switch every 2-D, symmetric, <= 8-bit quantized constant consumed
    only as a MatMul (or MatMulSplit) rhs to packed storage
    (kernels/pack.py: split-K at bits 1/2/4/8, bit-planes at odd widths),
    exactly bit_width bits per value. Under a tensor-parallel mesh a
    weight the rules row-shard packs per rank into the stacked layout.
    Returns the number of weights packed."""
    packed = 0
    for value in model.values:
        if not isinstance(value, Constant) \
                or not isinstance(value.data, QTensor):
            continue
        qt = value.data
        if qt.zero_point is not None or qt.data.ndim != 2 \
                or qt.bit_width > 8 \
                or not only_rhs_of(value, ("MatMul", "MatMulSplit")):
            continue
        shards = _row_shards(model, value.name) \
            if qt.bit_width in (1, 2, 4, 8) else 1
        value.data = pack_qtensor(qt, shards=shards)
        packed += 1
    model.invalidate_params()
    return packed


def weight_targets(qmodel, float_model) -> list:
    """[(node, weight Constant, float weight tensor)] of every MatMul/Gemm
    of ``qmodel`` whose weight is a symmetric quantized constant with a 2-D
    float source of the same name in ``float_model``: the weights GPTQ and
    AdaRound requantize."""
    f_consts = {v.name: v for v in float_model.values
                if isinstance(v, Constant)}
    out = []
    for node in qmodel.nodes:
        if node.op not in ("MatMul", "Gemm") or len(node.inputs) < 2:
            continue
        w = node.inputs[1]
        if not isinstance(w, Constant) or not isinstance(w.data, QTensor) \
                or w.data.zero_point is not None:
            continue  # weights quantize symmetric (PTQ invariant)
        fsrc = f_consts.get(w.name)
        if fsrc is None or not isinstance(fsrc.data, FTensor) \
                or fsrc.data.data.ndim != 2:
            continue
        out.append((node, w, fsrc.data.data.to(torch.float32)))
    return out


def target_rows(float_model, inputs: list, targets: list,
                max_rows: int) -> dict:
    """{input name: [rows, K] float32 activations} of the targets' inputs
    from one walk of ``float_model`` over ``inputs``, every (rows //
    max_rows + 1)th row kept above ``max_rows`` (the JAX passes'
    subsample)."""
    from ..utils.parity import record_values

    def rows(name, x):
        if x.ndim < 2:
            return None
        x = x.reshape(-1, x.shape[-1])
        if x.shape[0] > max_rows:
            x = x[:: x.shape[0] // max_rows + 1]
        return x.clone()

    acts = record_values(float_model, inputs,
                         {node.inputs[0].name for node, _, _ in targets},
                         rows)
    return {k: v for k, v in acts.items() if v is not None}


def float_array(value: Constant) -> np.ndarray:
    """A float Constant's values as a host float32 array."""
    return value.data.data.to("cpu", torch.float32).numpy()


def set_float(value: Constant, arr: np.ndarray) -> None:
    """Replace a float Constant's values with the host array ``arr`` (on the
    device the old values were on), keeping a host copy where the old
    tensor kept one (``graph.wrap_array``)."""
    arr = np.ascontiguousarray(arr, np.float32)
    old = value.data
    value.data = FTensor(torch.from_numpy(arr.copy()).to(old.data.device))
    if getattr(old, "host", None) is not None:
        value.data.host = arr


def shift_q_bias(value: Constant, corr: np.ndarray) -> int:
    """Subtract a per-channel float correction from a quantized bias
    Constant in its integer domain: q -= rint(corr / scale), clipped to
    the bias bit range (port of ``numpy_quant_tpu/passes/weights.py::
    shift_q_bias``). Returns 1 if applied, 0 if skipped."""
    qt = value.data
    scale = np.asarray(qt.scale, np.float32).reshape(-1)
    arr = qt.data.cpu().numpy()
    if corr.shape != arr.shape or np.any(scale == 0):
        return 0
    delta = np.rint(corr / scale.astype(np.float64))
    if not np.all(np.isfinite(delta)):
        return 0
    lo, hi = qrange(qt.bit_width)
    newq = np.clip(arr - delta, lo, hi).astype(arr.dtype)
    value.data = QTensor(torch.from_numpy(newq).to(qt.data.device),
                         qt.bit_width, qt.scale, qt.zero_point)
    return 1
