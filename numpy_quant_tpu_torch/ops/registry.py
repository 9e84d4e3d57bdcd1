"""ONNX operator implementations over the tensor layer (port of
``numpy_quant_tpu/ops/registry.py``), limited to the ops of the ViT
classifier and GPT decode graphs, the two fused ops and weight-only
MatMul/Gemm. Any other op raises ``NotImplementedError`` with its name."""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..quantization import as_tensor
from ..tensor import (
    FTensor,
    ITensor,
    PackedQTensor,
    QTensor,
    Tensor,
    concat,
    fconv2d,
    qconv2d,
    where,
)


def _resolve_reshape_shape(x_shape, shape: np.ndarray, allowzero: int) -> tuple:
    """ONNX Reshape: 0 copies the input dim (unless allowzero), -1 infers."""
    out = list(int(d) for d in shape)
    if not allowzero:
        for i, d in enumerate(out):
            if d == 0:
                out[i] = int(x_shape[i])
    return tuple(out)


def _zp_of(t: QTensor) -> int:
    return 0 if t.zero_point is None else int(t.zero_point)


def attention_call(inputs: list[Tensor], attrs: dict):
    """The kernel operands and keyword arguments of a FusedAttentionHS
    node: (q, k, v, kwargs, narrow_q). Narrow q (dead-token
    elimination) arrives rank-2 [B, H*D] and runs as one query row
    against full K/V."""
    if len(inputs) > 3 or attrs.get("causal_mask_val") is not None:
        raise NotImplementedError(
            "FusedAttentionHS with a score bias or causal mask is not ported")
    xq, xk, xv = inputs[0], inputs[1], inputs[2]
    assert isinstance(xq, QTensor) and isinstance(xk, QTensor) \
        and isinstance(xv, QTensor)
    narrow_q = xq.data.ndim == 2
    qdata = xq.data[:, None, :] if narrow_q else xq.data
    score_max = attrs.get("score_max")
    kwargs = dict(
        num_heads=int(attrs["num_heads"]),
        # bf16 serving mode takes the fewer-passes softmax; f32 the
        # executor-exact one
        fast=config.float_dtype == torch.bfloat16,
        score_max=None if score_max is None else float(score_max),
        scaling=float(attrs["scaling"]),
        sq=float(np.float32(xq.scale)), zq=_zp_of(xq),
        sk=float(np.float32(xk.scale)), zk=_zp_of(xk),
        sv=float(np.float32(xv.scale)), zv=_zp_of(xv),
        sp=float(attrs["probs_scale"]),
        zp_p=int(attrs["probs_zero_point"]),
        bit_width=xq.bit_width,
        out_requant=attrs.get("out_requant"))  # set by int8_dataflow
    return (qdata.to(torch.int8).contiguous(),
            xk.data.to(torch.int8).contiguous(),
            xv.data.to(torch.int8).contiguous(), kwargs, narrow_q)


def _fused_attention_hs(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    """The whole quantized attention block in one kernel launch
    (kernels/attention.py::fused_attention_hs) on the raw [B, N, H*D]
    Q/K/V projection outputs."""
    from ..kernels.attention import fused_attention_hs

    q, k, v, kwargs, narrow_q = attention_call(inputs, attrs)
    out = fused_attention_hs(q, k, v, **kwargs)
    if narrow_q:
        out = out[:, 0, :]
    out_requant = kwargs["out_requant"]
    if out_requant is not None:
        scale, zp = out_requant
        return [QTensor(out, inputs[0].bit_width,
                        np.float32(scale),
                        None if zp is None else np.int64(zp))]
    return [FTensor(out)]


def _fused_gelu(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    """The exporter's exact-GELU chain Div(x, c) -> Erf -> Add(one) ->
    Mul(x) -> Mul(half) as one op. f32 mode replays the chain's op
    sequence; the bf16 serving mode computes the sigmoid (tanh) form
    x * (half*(one-1) + 2*half * sigmoid(K1*x + K3*x^3))."""
    x, c_t, one_t, half_t = inputs[0], inputs[1], inputs[2], inputs[3]
    xd = x.data
    if config.float_dtype == torch.bfloat16:
        # tanh-form coefficients of erf(u), u = x/c, in f32 scalar math
        two_t1 = float(np.float32(2.0) * np.float32(1.1283791670955126))
        two_t3 = float(np.float32(2.0) * np.float32(0.10091094891335077))
        c32 = c_t.data.to(torch.float32)
        inv_c = 1.0 / c32 if attrs.get("via_div") else c32
        k1 = (two_t1 * inv_c).to(xd.dtype)
        k3 = (two_t3 * inv_c * inv_c * inv_c).to(xd.dtype)
        z = xd * (k1 + k3 * (xd * xd))
        if attrs.get("pure"):
            # one == 1, half == 0.5: 0.5*(1+tanh) IS sigmoid
            return [FTensor(xd * torch.sigmoid(z))]
        one32 = one_t.data.to(torch.float32)
        half32 = half_t.data.to(torch.float32)
        cc = (half32 * (one32 - 1.0)).to(xd.dtype)
        dd = (2.0 * half32).to(xd.dtype)
        return [FTensor(xd * (cc + dd * torch.sigmoid(z)))]
    from .erf import exact_erf
    u = xd / c_t.data if attrs.get("via_div") else xd * c_t.data
    e = exact_erf(u)
    a = e + one_t.data
    m = xd * a
    return [FTensor(m * half_t.data)]


def _packed_matmul(a: QTensor, b: PackedQTensor) -> FTensor:
    """Quantized activation x packed weight -> dequantized f32 through the
    packed kernels (kernels/qmatmul.py), which fuse the zero-point
    correction and the dequantize. An activation with a tensor zero point
    takes the unpacked product instead, as in the JAX package."""
    if a.zero_point is not None and getattr(a.zero_point, "ndim", 0) > 0:
        return a.matmul(b.unpack()).dequantize()
    from ..kernels.qmatmul import packed_qmatmul, splitk_qmatmul

    data = a.data
    lead = data.shape[:-1]
    x2 = data.reshape(-1, data.shape[-1])
    scale_vec = b.scale_vec()
    scale_kw = {"w_scale_vec": scale_vec} if scale_vec is not None \
        else {"w_scale": float(np.float32(b.scale))}
    kernel_fn = splitk_qmatmul if b.layout == "splitk" else packed_qmatmul
    y2 = kernel_fn(
        x2, b.planes, b.colsum, None,
        bits=b.bit_width, bit_width=a.bit_width,
        x_scale=float(np.float32(a.scale)),
        x_zp=None if a.zero_point is None else int(a.zero_point),
        quantize_x=False, **scale_kw)
    return FTensor(y2.reshape(*lead, b.n))


def _weight_only_matmul(a: FTensor, b) -> FTensor:
    """Float activation x quantized weight (Model.quantize_weights): int
    weights, float compute. Under ``packed_execution == "kernel"`` a
    split-K packed weight whose scale groups tile its bit fields runs
    ``splitk_wo_matmul``, which streams the packed payload and dequantizes
    it in the weight load; otherwise the weight unpacks to int8 and
    dequantizes here."""
    from ..kernels.qmatmul import splitk_wo_matmul, wo_groups_tile

    groups = int(b.scale.shape[0]) if getattr(b.scale, "ndim", 0) == 2 else 1
    if isinstance(b, PackedQTensor) and b.layout == "splitk" \
            and config.packed_execution == "kernel" \
            and wo_groups_tile(b.k, b.planes.shape[0], groups, b.bit_width):
        xd = a.data
        scale = b.scale_vec()
        y2 = splitk_wo_matmul(
            xd.reshape(-1, xd.shape[-1]), b.planes,
            float(np.float32(b.scale)) if scale is None else scale,
            bits=b.bit_width)
        return FTensor(y2.reshape(*xd.shape[:-1], b.n))
    scale = b.scale_vec() if isinstance(b, PackedQTensor) else None
    w = b.unpack() if isinstance(b, PackedQTensor) else b
    s = w.scale
    if getattr(s, "ndim", 0) == 2 and s.shape[0] > 1:
        # grouped scales [K/g, N]: the group-batched product
        # y = sum_g (x_g @ W_g) * s[g], as the JAX package computes it
        kdim, ncol = w.data.shape
        g = int(s.shape[0])
        xd = a.data
        x3 = xd.reshape(*xd.shape[:-1], g, kdim // g)
        wq = w.data.reshape(g, kdim // g, ncol).to(xd.dtype)
        part = torch.einsum("...gk,gkn->...gn", x3, wq)
        if scale is None:
            scale = as_tensor(s, xd.device)
        return FTensor(torch.sum(part * scale.to(xd.dtype), dim=-2))
    return a.matmul(w.dequantize())


def _matmul(a: Tensor, b: Tensor) -> list[Tensor]:
    if isinstance(a, FTensor) and isinstance(b, (QTensor, PackedQTensor)):
        return [_weight_only_matmul(a, b)]
    if isinstance(b, PackedQTensor):
        if config.packed_execution == "kernel" and isinstance(a, QTensor):
            return [_packed_matmul(a, b)]
        return [a.matmul(b.unpack())]
    return [a.matmul(b)]


def _layer_norm(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    x, scale = inputs[0], inputs[1]
    bias = inputs[2] if len(inputs) > 2 else None
    axis = int(attrs.get("axis", -1))
    epsilon = float(attrs.get("epsilon", 1e-5))
    if isinstance(x, FTensor) and config.float_dtype == torch.bfloat16:
        # serving mode: one-pass moments in f32 (sum x, sum x*x)
        xd = x.data.to(torch.float32)
        mean = torch.mean(xd, dim=axis, keepdim=True)
        msq = torch.mean(xd * xd, dim=axis, keepdim=True)
        var = msq - mean * mean
        inv = torch.rsqrt(var + np.float32(epsilon))
        y = (xd - mean) * inv
        y = y.to(x.data.dtype) * scale.data
        if bias is not None:
            y = y + bias.data
        return [FTensor(y)]
    # the reference's two-pass decomposition
    mean = x.mean(axis=axis, keepdims=True)
    d = x + (-mean)
    dd = d * d
    var = dd.mean(axis=axis, keepdims=True)
    vareps = var + epsilon
    stddev = vareps.sqrt()
    normalized = d * stddev.inv()
    y = normalized * scale
    if bias is not None:
        y = y + bias
    return [y]


def _gemm(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    x, w = inputs[0], inputs[1]
    if isinstance(x, FTensor) and isinstance(w, (QTensor, PackedQTensor)):
        # weight-only (Model.quantize_weights): dequantize before transB,
        # so the stored per-channel scale keeps its orientation
        w = (w.unpack() if isinstance(w, PackedQTensor) else w).dequantize()
    b = inputs[2] if len(inputs) > 2 else None
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    if attrs.get("transA"):
        x = x.T
    if attrs.get("transB"):
        w = w.T
    y = x.matmul(w)
    if alpha != 1.0:
        if isinstance(y, QTensor):
            # alpha folds into the accumulator scale exactly; beta was
            # folded into the bias scale at quantize() time
            y = QTensor(y.data, y.bit_width,
                        np.asarray(y.scale, np.float32) * np.float32(alpha),
                        y.zero_point)
        else:
            y = y * FTensor(torch.full((), alpha, device=y.data.device))
    if b is not None and beta != 0.0:
        if beta != 1.0 and not isinstance(b, QTensor):
            b = b * FTensor(torch.full((), beta, device=b.data.device))
        y = y + b
    return [y]


def _conv(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    x, w = inputs[0], inputs[1]
    b = inputs[2] if len(inputs) > 2 else None
    if x.data.ndim != 4:
        raise NotImplementedError("only 2-D Conv is ported")
    group = int(attrs.get("group", 1))
    pads = tuple(attrs.get("pads", (0, 0, 0, 0)))
    strides = tuple(attrs.get("strides", (1, 1)))
    dils = tuple(attrs.get("dilations", (1, 1)))
    if isinstance(x, QTensor):
        return [qconv2d(x, w, b, pads, strides, dils, group)]
    return [fconv2d(x, w, b, pads, strides, dils, group)]


def _slice(inputs: list[Tensor]) -> list[Tensor]:
    x = inputs[0]
    starts, ends = inputs[1].data, inputs[2].data
    ndim = len(x.shape) if isinstance(x, QTensor) else x.shape.size
    axes = inputs[3].data if len(inputs) > 3 and inputs[3] is not None \
        else np.arange(len(starts))
    steps = inputs[4].data if len(inputs) > 4 and inputs[4] is not None \
        else np.ones(len(starts), dtype=np.int64)
    slices = [slice(None, None, None)] * ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        slices[int(a)] = slice(int(s), int(e), int(st))
    return [x[tuple(slices)]]


def _split(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    x = inputs[0]
    axis = int(attrs.get("axis", 0))
    dims = tuple(int(d) for d in x.shape.data)
    if len(inputs) > 1 and inputs[1] is not None:
        sizes = [int(s) for s in inputs[1].data]
    elif "split" in attrs:
        sizes = [int(s) for s in attrs["split"]]
    else:
        n_out = int(attrs.get("num_outputs", 2))
        q, r = divmod(dims[axis], n_out)
        sizes = [q + (1 if i < r else 0) for i in range(n_out)]
    outs = []
    start = 0
    for s in sizes:
        sl = [slice(None)] * len(dims)
        sl[axis] = slice(start, start + s)
        outs.append(x[tuple(sl)])
        start += s
    return outs


def _constant(attrs: dict, device) -> list[Tensor]:
    value = attrs["value"]
    if value.dtype == np.float32:
        return [FTensor(torch.from_numpy(np.array(value)).to(device))]
    if value.dtype in (np.int64, np.int32):
        return [ITensor(value)]
    raise ValueError(f"Constant value dtype {value.dtype} not supported.")


def onnx_operator_implementation(op: str, inputs: list[Tensor],
                                 attrs: dict[str, object],
                                 device=None) -> list[Tensor]:
    """Run one op; ``device`` places the tensors a Constant node makes."""
    if op == "Add":
        return [inputs[0] + inputs[1]]
    if op == "Concat":
        return [concat(list(inputs), axis=attrs["axis"])]
    if op == "Constant":
        return _constant(attrs, device)
    if op == "Conv":
        return _conv(inputs, attrs)
    if op == "Div":
        return [inputs[0].div(inputs[1])]
    if op == "Equal":
        return [inputs[0] == inputs[1]]
    if op == "Erf":
        return [inputs[0].erf()]
    if op == "Expand":
        return [inputs[0].expand(inputs[1])]
    if op == "Gather":
        return [inputs[0].take(inputs[1], axis=int(attrs.get("axis", 0)))]
    if op == "Gemm":
        return _gemm(inputs, attrs)
    if op == "Identity":
        return [inputs[0].copy()]
    if op == "LayerNormalization":
        return _layer_norm(inputs, attrs)
    if op == "MatMul":
        return _matmul(inputs[0], inputs[1])
    if op == "Mul":
        return [inputs[0] * inputs[1]]
    if op == "Reshape":
        x, shape = inputs[0], inputs[1]
        x_shape = x.shape if isinstance(x, QTensor) \
            else tuple(int(d) for d in x.shape.data)
        resolved = _resolve_reshape_shape(x_shape, shape.data,
                                          int(attrs.get("allowzero", 0)))
        return [x.reshape(ITensor(np.array(resolved, dtype=np.int64)))]
    if op == "Shape":
        x = inputs[0]
        if isinstance(x, QTensor):
            return [ITensor(np.array(x.shape, dtype=np.int64))]
        return [x.shape]
    if op == "Slice":
        return _slice(inputs)
    if op == "Softmax":
        return [inputs[0].softmax(axis=int(attrs.get("axis", -1)))]
    if op == "Split":
        return _split(inputs, attrs)
    if op == "Transpose":
        x = inputs[0]
        perm = attrs.get("perm")
        if perm is None:
            ndim = len(x.shape) if isinstance(x, QTensor) else x.shape.size
            perm = tuple(reversed(range(ndim)))
        return [x.transpose(tuple(int(p) for p in perm))]
    if op == "Unsqueeze":
        x = inputs[0]
        if len(inputs) > 1 and inputs[1] is not None:
            axes = inputs[1]
        else:
            axes = ITensor(np.array(attrs["axes"], dtype=np.int64))
        return [x.expand_dims(axis=axes)]
    if op == "Where":
        return [where(inputs[0], inputs[1], inputs[2])]
    if op == "FusedAttentionHS":
        return _fused_attention_hs(inputs, attrs)
    if op == "FusedGelu":
        return _fused_gelu(inputs, attrs)
    raise NotImplementedError(f"ONNX op {op!r} is not ported")
