"""Cross-layer equalization (Nagel et al., arXiv:1906.04721 -- the
"data-free quantization" pass, AIMET's CLE); port of
``numpy_quant_tpu/equalize.py``.

Consecutive constant-weight Conv/MatMul/Gemm layers joined by
positively homogeneous ops (ReLU, MaxPool) admit an exact rescaling that
balances their channel ranges:

    s_i = sqrt(r1_i / r2_i)          r = per-channel weight amax
    W1[ch i] /= s_i,  b1_i /= s_i    (producer output channel)
    W2[ch i] *= s_i                  (consumer input channel)

ReLU(x / s) = ReLU(x) / s for s > 0, so the float function is unchanged
while both layers' channel ranges flatten and per-tensor weight
quantization stops being set by one wide channel. Data-free; the factors
and the rewrite are the JAX package's float32 host arithmetic. Run on the
FLOAT model before ``quantize``.
"""
from __future__ import annotations

import numpy as np

from .graph import Constant
from .passes.weights import float_array, set_float
from .tensor import FTensor

# ops that commute with positive per-channel scaling of their input
_HOMOGENEOUS = ("Relu", "MaxPool")


def _weight(node):
    w = node.inputs[1] if len(node.inputs) > 1 else None
    if isinstance(w, Constant) and isinstance(getattr(w, "data", None),
                                              FTensor):
        return w
    return None


def _axes(node, W):
    """(output-channel axis when node is the producer, input-channel
    axis when it is the consumer) of the stored weight, or None."""
    if node.op == "Conv":
        if W.ndim != 4:
            return None
        if int(node.attrs.get("group", 1)) != 1:
            return None  # grouped/depthwise: channels do not mix 1:1
        return 0, 1
    if W.ndim != 2:
        return None
    if node.op == "MatMul":
        return 1, 0                      # y = x @ W[K, N]
    if node.op == "Gemm":
        if node.attrs.get("transA"):
            return None
        if node.attrs.get("transB"):
            return 0, 1                  # y = x @ W[N, K].T
        return 1, 0
    return None


def equalize(model, iterations: int = 2) -> int:
    """Equalize every producer -> (Relu/MaxPool chain) -> consumer pair
    of constant-weight Conv/MatMul/Gemm layers, ``iterations`` sweeps
    (pairs sharing a layer converge in a couple of rounds). Mutates the
    float model in place; quantize afterwards. Returns the number of
    pairs per sweep."""

    def consumers(v):
        return [n for n in model.nodes if v in n.inputs]

    # every value between the pair is rescaled by 1/s: if one is also a
    # graph OUTPUT, equalizing would change observable model outputs
    out_names = {o.name for o in model.outputs}

    pairs = 0
    for sweep in range(max(1, int(iterations))):
        count = 0
        for node in model.nodes:
            w1 = _weight(node)
            if w1 is None:
                continue
            ax1 = _axes(node, w1.data.data)
            if ax1 is None:
                continue
            # inline bias (Conv/Gemm input 2, rank-1 constant)
            biases = []
            if len(node.inputs) > 2 and isinstance(node.inputs[2], Constant) \
                    and isinstance(node.inputs[2].data, FTensor) \
                    and node.inputs[2].data.data.ndim == 1:
                biases.append(node.inputs[2])
            # walk the single-consumer chain: optional rank-1 Add bias
            # (the exporter's MatMul linear form), then homogeneous ops
            v = node.outputs[0]
            if v.name in out_names:
                continue
            cons = consumers(v)
            if len(cons) == 1 and cons[0].op == "Add" \
                    and cons[0].inputs[0] is v:
                other = cons[0].inputs[1]
                if isinstance(other, Constant) \
                        and isinstance(other.data, FTensor) \
                        and other.data.data.ndim == 1:
                    biases.append(other)
                    v = cons[0].outputs[0]
                    cons = consumers(v)
            saw_homogeneous = False
            while len(cons) == 1 and cons[0].op in _HOMOGENEOUS \
                    and cons[0].inputs[0] is v and v.name not in out_names:
                saw_homogeneous = True
                v = cons[0].outputs[0]
                cons = consumers(v)
            if not saw_homogeneous or v.name in out_names:
                continue  # direct linear pairs fold; outputs must not
                # rescale
            if len(cons) != 1 or cons[0].inputs[0] is not v:
                continue
            w2 = _weight(cons[0])
            if w2 is None or w2 is w1:
                continue
            ax2 = _axes(cons[0], w2.data.data)
            if ax2 is None:
                continue

            W1 = float_array(w1)
            W2 = float_array(w2)
            out_ax, in_ax = ax1[0], ax2[1]
            red1 = tuple(i for i in range(W1.ndim) if i != out_ax)
            red2 = tuple(i for i in range(W2.ndim) if i != in_ax)
            r1 = np.abs(W1).max(axis=red1)
            r2 = np.abs(W2).max(axis=red2)
            if r1.shape != r2.shape:
                continue
            s = np.sqrt(np.maximum(r1, 1e-12) / np.maximum(r2, 1e-12))
            s = np.where((r1 <= 0) | (r2 <= 0), 1.0, s).astype(np.float32)

            sh1 = [1] * W1.ndim
            sh1[out_ax] = -1
            set_float(w1, W1 / s.reshape(sh1))
            sh2 = [1] * W2.ndim
            sh2[in_ax] = -1
            set_float(w2, W2 * s.reshape(sh2))
            for b in biases:
                set_float(b, float_array(b) / s)
            count += 1
        pairs = count
        if count == 0:
            break

    if pairs:
        model.invalidate_params()
    return pairs
