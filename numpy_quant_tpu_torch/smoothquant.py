"""SmoothQuant-style activation-outlier migration (Xiao et al.,
arXiv:2211.10438); port of ``numpy_quant_tpu/smoothquant.py``.

For a LayerNormalization (or the decomposed RMSNorm's final Mul) whose
output feeds only constant-weight MatMul/Gemm nodes, the exact
reparameterization

    s_j    = amax_x(j)^alpha / amax_w(j)^(1-alpha)
    gamma' = gamma / s,  beta' = beta / s          (the norm emits x / s)
    W'[j]  = s_j * W[j]                             (consumers absorb s)

leaves every consumer's float function as it was while the norm output's
per-channel range flattens, so a per-tensor activation scale wastes fewer
levels on outlier channels. Run on the FLOAT model before ``quantize``.
The factors are computed on the host in float64 numpy, as the JAX package
computes them, from per-channel maxima the walk reduces on the device.
"""
from __future__ import annotations

import numpy as np

from .graph import Constant
from .passes.weights import float_array, set_float
from .tensor import FTensor
from .utils.parity import record_values


def _float_const(value, ndim: int = None) -> bool:
    return isinstance(value, Constant) \
        and isinstance(getattr(value, "data", None), FTensor) \
        and (ndim is None or value.data.data.ndim == ndim)


def _rms_norm_tail(node):
    """The 1-D weight Constant of a decomposed RMSNorm's final node
    (``Mul(Div(x, Sqrt(...)), weight)``, models/llama.py), else None."""
    if node.op != "Mul" or len(node.inputs) != 2:
        return None
    w = node.inputs[1]
    if not _float_const(w, 1):
        return None
    div_val = node.inputs[0]
    prods = getattr(div_val, "inputs", None)
    if not prods or len(prods) != 1 or prods[0].op != "Div":
        return None
    std_val = prods[0].inputs[1]
    sprods = getattr(std_val, "inputs", None)
    if not sprods or len(sprods) != 1 or sprods[0].op != "Sqrt":
        return None
    return w


def ln_matmul_groups(model) -> list:
    """Every exactly-reparameterizable group: a LayerNormalization
    (last axis, constant gamma/beta) or a decomposed RMSNorm whose output
    is not a graph output and feeds ONLY constant-weight MatMul/Gemm
    nodes (Shape readers aside). Returns [(norm_node, gamma, beta,
    out_value, ws)], ``ws`` = [(weight_constant, axis)] with ``axis`` the
    weight axis over the norm's channels (0: rows of [K, N]; 1: columns
    of a transB [N, K])."""
    groups = []
    for node in model.nodes:
        if node.op == "LayerNormalization" and len(node.inputs) >= 2:
            if int(node.attrs.get("axis", -1)) != -1:
                continue
            gamma = node.inputs[1]
            beta = node.inputs[2] if len(node.inputs) > 2 else None
        else:
            gamma = _rms_norm_tail(node)
            if gamma is None:
                continue
            beta = None
        if not _float_const(gamma):
            continue
        if beta is not None and not _float_const(beta):
            continue
        out = node.outputs[0]
        if any(out.name == o.name for o in model.outputs):
            continue  # a graph output must not rescale
        consumers = [n for n in model.nodes if out in n.inputs]
        if not consumers:
            continue
        ws = []
        ok = True
        for c in consumers:
            if c.op == "Shape":
                continue  # reads dims, never data
            w = c.inputs[1] if len(c.inputs) > 1 else None
            w_ok = _float_const(w, 2)
            if c.op == "MatMul" and c.inputs[0] is out and w_ok:
                ws.append((w, 0))
            elif c.op == "Gemm" and c.inputs[0] is out and w_ok \
                    and not c.attrs.get("transA"):
                ws.append((w, 1 if c.attrs.get("transB") else 0))
            else:
                ok = False  # a consumer cannot absorb 1/s: skip the norm
                break
        if ok and ws:
            groups.append((node, gamma, beta, out, ws))
    return groups


def apply_channel_scale(gamma, beta, ws, s: np.ndarray) -> None:
    """The reparameterization both smooth_outliers and AWQ apply: the norm
    emits x / s and every consumer weight absorbs s on its norm-channel
    axis (float32 host arithmetic, as the JAX package's)."""
    set_float(gamma, float_array(gamma) / s)
    if beta is not None:
        set_float(beta, float_array(beta) / s)
    for w, axis in ws:
        W = float_array(w)
        set_float(w, W * (s[:, None] if axis == 0 else s[None, :]))


def channel_absmax(model, inputs: list, names) -> dict:
    """{value name: per-last-axis-channel max |x| as host float64} over
    one eager walk, reduced on the device."""
    def keep(name, t):
        return t.abs().reshape(-1, t.shape[-1]).amax(dim=0)

    return {k: v.cpu().numpy().astype(np.float64)
            for k, v in record_values(model, inputs, names, keep).items()}


def smooth_outliers(model, inputs: list, alpha: float = 0.5) -> int:
    """Migrate activation outliers into the weights of every norm group
    (:func:`ln_matmul_groups`). ``inputs``: a calibration batch. Mutates
    the float model in place; quantize afterwards. Returns the number of
    smoothed groups."""
    groups = ln_matmul_groups(model)
    amax = channel_absmax(model, inputs, [g[3].name for g in groups])
    smoothed = 0
    for _node, gamma, beta, out, ws in groups:
        g = float_array(gamma)
        k = g.shape[-1]
        amax_x = amax.get(out.name)
        if amax_x is None or g.ndim != 1 or amax_x.shape[-1] != k:
            continue
        amax_w = np.zeros(k, np.float64)
        for w, axis in ws:
            W = np.abs(float_array(w).astype(np.float64))
            amax_w = np.maximum(amax_w, W.max(axis=1 - axis))
        s = amax_x ** alpha / np.maximum(amax_w, 1e-12) ** (1.0 - alpha)
        s = np.where((amax_x <= 0) | (amax_w <= 0), 1.0, s)
        s = np.clip(s, 1e-5, None).astype(np.float32)
        apply_channel_scale(gamma, beta, ws, s)
        smoothed += 1
    if smoothed:
        model.invalidate_params()
    return smoothed
