"""ONNX operator implementations over the tensor layer (port of
``numpy_quant_tpu/ops/registry.py``): the core ops here, the four fused
ops, weight-only MatMul/Gemm, the interop ops of ``interop.py`` (QDQ,
QOperator, dynamic quantization, Cast, ConstantOfShape), LSTM/GRU
(``recurrent.py``) and the standard op set of ``standard.py`` --
every op name the JAX package dispatches, ``MatMulSplit`` (the merged
Q/K/V product of passes/matmul_merge.py) included. If/Loop run in ``Model``
(their bodies are graphs). Any other op raises ``NotImplementedError``
with its name."""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..intops import fma_f32 as _fma_f32, place, replays_xla
from ..quantization import as_tensor, fake_quantize
from ..tensor import (
    DITensor,
    FTensor,
    ITensor,
    PackedQTensor,
    QTensor,
    Tensor,
    _take,
    concat,
    fconv2d,
    qconv2d,
    where,
)
from .interop import OPS as INTEROP_OPS
from .recurrent import recurrent
from .standard import OPS as STANDARD_OPS, conv1d_op


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


def score_bias_operand(bias: Tensor, num_heads: int, nq: int, n: int):
    """The 4th FusedAttentionHS input as the kernels take it: dequantized
    exactly as the unfused Add dequantizes it, its leading 1-dims dropped,
    a 2-D bias lifted to [1, nq, n], broadcast to a contiguous float32
    [H, nq, n] on the device (JAX ``ops/registry.py:898-916``)."""
    if isinstance(bias, QTensor):
        bias = bias.dequantize()
    arr = bias.data.to(torch.float32)
    while arr.ndim > 3:
        if arr.shape[0] != 1:
            raise ValueError(f"score bias {tuple(bias.data.shape)} does not "
                             "broadcast over the batch")
        arr = arr[0]
    if arr.ndim == 2:
        arr = arr[None]
    return torch.broadcast_to(arr, (num_heads, nq, n)).contiguous()


def attention_call(inputs: list[Tensor], attrs: dict):
    """The kernel operands and keyword arguments of a FusedAttentionHS
    node: (q, k, v, kwargs, narrow_q). Narrow q (dead-token
    elimination) arrives rank-2 [B, H*D] and runs as one query row
    against full K/V. A decoder's causal mask (``causal_mask_val``, the
    dequantized mask constant, and the band ``causal_window``) is added
    inside the kernel, and so is the optional 4th input, a score-bias
    constant (``score_bias``, [H, nq, N] float32)."""
    xq, xk, xv = inputs[0], inputs[1], inputs[2]
    assert isinstance(xq, QTensor) and isinstance(xk, QTensor) \
        and isinstance(xv, QTensor)
    narrow_q = xq.data.ndim == 2
    qdata = xq.data[:, None, :] if narrow_q else xq.data
    num_heads = int(attrs["num_heads"])
    score_bias = None
    if len(inputs) > 3 and inputs[3] is not None:
        score_bias = score_bias_operand(inputs[3], num_heads,
                                        qdata.shape[1], xk.data.shape[1])
    score_max = attrs.get("score_max")
    causal_mask_val = attrs.get("causal_mask_val")
    causal_window = attrs.get("causal_window")
    kwargs = dict(
        causal_mask_val=None if causal_mask_val is None
        else float(causal_mask_val),
        causal_window=None if causal_window is None else int(causal_window),
        score_bias=score_bias,
        num_heads=num_heads,
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
        out_requant=attrs.get("out_requant"),  # set by int8_dataflow
        # a tensor-parallel rank's heads among the model's (parallel/walk.py)
        head_base=int(attrs.get("head_base", 0)),
        head_total=attrs.get("head_total"))
    return (qdata.to(torch.int8).contiguous(),
            xk.data.to(torch.int8).contiguous(),
            xv.data.to(torch.int8).contiguous(), kwargs, narrow_q)


def _fused_attention_hs(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    """The whole quantized attention block in one kernel launch
    (kernels/attention.py::fused_attention_hs, which hands long
    sequences to the blockwise kernel) on the raw [B, N, H*D] Q/K/V
    projection outputs."""
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


def plain_attention_call(inputs: list[Tensor], attrs: dict):
    """The kernel operands and keyword arguments of a FusedAttention node:
    (q, kt, v, kwargs). The quantized q-heads [..., N, D], transposed
    k-heads [..., D, N] and v-heads [..., N, D] flatten to contiguous int8
    [-1, N, D], [-1, D, N] and [-1, N, D]."""
    q, kt, v = inputs[0], inputs[1], inputs[2]
    assert isinstance(q, QTensor) and isinstance(kt, QTensor) \
        and isinstance(v, QTensor)
    n, d = q.data.shape[-2], q.data.shape[-1]
    causal_mask_val = attrs.get("causal_mask_val")
    causal_window = attrs.get("causal_window")
    kwargs = dict(
        causal_mask_val=None if causal_mask_val is None
        else float(causal_mask_val),
        causal_window=None if causal_window is None else int(causal_window),
        scaling=float(attrs["scaling"]),
        sq=float(np.float32(q.scale)), zq=_zp_of(q),
        sk=float(np.float32(kt.scale)), zk=_zp_of(kt),
        sv=float(np.float32(v.scale)), zv=_zp_of(v),
        sp=float(attrs["probs_scale"]),
        zp_p=int(attrs["probs_zero_point"]),
        bit_width=q.bit_width,
        out_requant=attrs.get("out_requant"))  # set by int8_dataflow
    whole = attrs.get("lead_whole")
    if whole is not None:
        # a tensor-parallel rank's [B, H] block of the whole grid
        # (parallel/walk.py): its softmax rows sum where they lie there
        heads, total = int(q.data.shape[1]), int(whole[1])
        b0, h0 = (int(i) for i in attrs["lead_base"])
        kwargs.update(num_heads=heads, head_total=total,
                      head_base=b0 * total + h0)
    return (q.data.to(torch.int8).reshape(-1, n, d).contiguous(),
            kt.data.to(torch.int8).reshape(-1, d, n).contiguous(),
            v.data.to(torch.int8).reshape(-1, n, d).contiguous(), kwargs)


def _fused_attention(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    """The whole quantized attention block on pre-split heads in one kernel
    launch (kernels/attention.py::fused_attention); the plain fusion leaves
    the head shuffles in the graph."""
    from ..kernels.attention import fused_attention

    q, kt, v, kwargs = plain_attention_call(inputs, attrs)
    out = fused_attention(q, kt, v, **kwargs)
    out = out.reshape(inputs[0].data.shape)
    out_requant = kwargs["out_requant"]
    if out_requant is not None:
        scale, zp = out_requant
        return [QTensor(out, inputs[0].bit_width, np.float32(scale),
                        None if zp is None else np.int64(zp))]
    return [FTensor(out)]


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted float type (jnp's promotion;
    torch.matmul takes one type)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


# XLA's CPU compiler (jaxlib 0.9, an AVX-512 host) hands a float32 dot
# [m, k] @ [k, n] to YNNPACK where it has more than 50 rows, or at most 16
# columns, with 2 rows and 2 columns at least; elsewhere to Eigen, whose
# order is one fused multiply-add chain per output from k = 0. Below 11
# products a sum its order is not mapped (9 and 10 part from the lanes).
_YNN_MIN_ROWS = 51
_YNN_MIN_DEPTH = 11
_YNN_MAX_NARROW = 16
_YNN_TILE = 64  # accumulator columns of YNNPACK's kernel, per row


def _ynn_lanes(m: int, k: int, n: int) -> int:
    """The k lanes of XLA's CPU float32 dot of an [m, k] @ [k, n] product,
    0 where YNNPACK does not take it or k is below 11. Its kernel keeps 64
    accumulator columns a row: n tiled by 64 where 64 divides it, by 32
    where 32 does, else by 16, and 64 // tile lanes of k (k mod lanes)
    fill the rest (``extras/xla_cpu_order_probe.py`` checks it). The rule
    was mapped on jaxlib 0.9.0 on an AVX-512 CPU; another jaxlib or vector
    unit may route or tile the dot otherwise, and the CPU parity tests
    then fail first on ``tests/torch_parity.py::
    assert_mapped_xla_cpu_host``."""
    if m < 2 or n < 2 or k < _YNN_MIN_DEPTH \
            or (m < _YNN_MIN_ROWS and n > _YNN_MAX_NARROW):
        return 0
    tile = 64 if n % 64 == 0 else 32 if n % 32 == 0 else 16
    return _YNN_TILE // tile


def _lane_sums(a: torch.Tensor, b: torch.Tensor, lanes: int) -> torch.Tensor:
    """a [..., m, s·lanes] @ b [..., s·lanes, n] in ``lanes`` k lanes, each
    a chain of fused multiply-adds from 0, finished by adjacent pairs:
    (l0 + l1) + (l2 + l3)."""
    steps = a.shape[-1] // lanes
    ar = a.reshape(*a.shape[:-1], steps, lanes).movedim(-1, -3)
    br = b.reshape(*b.shape[:-2], steps, lanes, b.shape[-1])
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                      + (lanes, a.shape[-2], b.shape[-1]))
    # ar [..., lanes, m, steps], br [..., steps, lanes, n]
    for j in range(steps):
        acc = _fma_f32(ar[..., j:j + 1], br[..., j, :, None, :], acc)
    while acc.shape[-3] > 1:
        acc = acc[..., 0::2, :, :] + acc[..., 1::2, :, :]
    return acc[..., 0, :, :]


def _xla_cpu_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., m, k] @ b [..., k, n] of float32 CPU tensors, bit for bit
    as XLA's CPU compiler sums it where YNNPACK takes the dot
    (``_ynn_lanes``): the first k // lanes · lanes products in the lanes,
    the rest one to a lane of a second set summed alike, the two added;
    torch.matmul elsewhere. k // lanes + 1 vectorized steps at most."""
    lanes = _ynn_lanes(a.shape[-2], a.shape[-1], b.shape[-1])
    if lanes == 0:
        return torch.matmul(a, b)
    k = a.shape[-1]
    main = k // lanes * lanes
    out = _lane_sums(a[..., :main], b[..., :main, :], lanes)
    if main < k:
        pad = lanes - (k - main)
        tail = _lane_sums(
            torch.nn.functional.pad(a[..., main:], (0, pad)),
            torch.nn.functional.pad(b[..., main:, :], (0, 0, 0, pad)), lanes)
        out = out + tail
    return out


def _context_dot(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs [..., 1, L] @ values [..., L, D]. On the CPU a float32 product
    sums in XLA's CPU order for this dot, one fused multiply-add per key
    from key 0 on, so the plain path equals JAX's context bit for bit
    (another order moves an ulp, and the int8 quantize after the op can
    round it across a step); elsewhere torch.matmul."""
    p, v = _promoted(p, v)
    if p.device.type != "cpu" or p.dtype != torch.float32:
        return torch.matmul(p, v)
    out = torch.zeros(torch.broadcast_shapes(p.shape[:-2], v.shape[:-2])
                      + (p.shape[-2], v.shape[-1]), dtype=torch.float32)
    for k in range(p.shape[-1]):
        out = _fma_f32(p[..., :, k:k + 1], v[..., k:k + 1, :], out)
    return out


def _decode_attention(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    """Fused decode-step attention (passes/decode_attention.py): scores
    over [cache | current], the scale/mask/bias epilogue, softmax and the
    context, with the cache dequantize fused into the dot operands. Every
    quantization the unfused executor applies is replayed with the same
    calibrated params through quantization.quantize/dequantize (the hand
    kernels on the card): fake-quant of q, the caches, the step key and
    the cache probabilities (quantization.fake_quantize: one launch, the
    cache probabilities read where they lie in probs), dequantize of int8
    inputs; an accumulator arriving at another width requantizes first,
    as the unfused executor
    narrows it. The three dots are float products (torch.matmul; JAX's
    jnp.einsum outside any kernel); on the CPU the context product sums in
    XLA's order (``_context_dot``). The fake-quant values are float32, so
    a quantized model's dots run in float32 in the bf16 serving mode too
    (TF32 off); a float model's run in the data plane's dtype."""
    q, kc, kh, vc, vh = inputs[:5]
    extras = list(inputs[5:])
    cache_len = int(attrs["cache_len"])
    bw = attrs.get("bit_width")

    def as_float(t, qp_key):
        qp = attrs.get(qp_key)
        if isinstance(t, QTensor):
            if bw is not None and t.bit_width != bw and qp is not None:
                t = t.requantize(bw, np.float32(qp[0]), qp[1])
            return t.dequantize().data
        if qp is None:
            return t.data
        scale = np.float32(qp[0])
        return fake_quantize(t.data, bw, scale, qp[1], container=torch.int8)

    qf = as_float(q, "q_qp")            # [B, H, 1, D]
    whole = attrs.get("lead_whole")
    local = tuple(qf.shape[:2])
    lead = None if whole is None else tuple(
        slice(b, b + n) for b, n in zip(attrs["lead_base"], local))

    def placed(t):
        # a rank's block of a tensor-parallel step, placed where it lies in
        # the whole [B, H] grid (zeros elsewhere): cuBLAS picks its kernel,
        # and so its summation order, by the batch of the product, so the
        # rank's dots equal the single process's only at its shape
        if lead is None or t.ndim < 4:
            return t
        # an axis of q's local size is this rank's; a size-1 axis of a
        # wider q broadcasts
        real = [t.shape[i] == local[i] for i in range(2)]
        out = t.new_zeros([whole[i] if real[i] else 1 for i in range(2)]
                          + list(t.shape[2:]))
        out[tuple(lead[i] if real[i] else slice(None)
                  for i in range(2))] = t
        return out

    qf = placed(qf)
    kcf = placed(as_float(kc, "ktc_qp"))  # [B, H, L, D]
    khf = placed(as_float(kh, "kts_qp"))  # [B, H, 1, D]
    s_past = torch.matmul(*_promoted(qf, kcf.transpose(-1, -2)))
    s_self = torch.matmul(*_promoted(qf, khf.transpose(-1, -2)))
    s = torch.cat(_promoted(s_past, s_self), dim=-1)
    for kind, val in attrs["epilogue"]:
        if kind == "mul":
            s = s * torch.full((), float(val), dtype=s.dtype, device=s.device)
        else:
            e = extras[int(val)]
            e = e.dequantize().data if isinstance(e, QTensor) else e.data
            s, e = _promoted(s, placed(e))
            s = s + e
    probs = FTensor(s).softmax(axis=-1).data
    p_past, p_self = probs[..., :cache_len], probs[..., cache_len:]
    if bw is not None and attrs.get("p_qp") is not None:
        sp, zp = np.float32(attrs["p_qp"][0]), attrs["p_qp"][1]
        p_past = fake_quantize(p_past, bw, sp, zp, container=torch.int8)
    vcf = placed(as_float(vc, "vc_qp"))  # [B, H, L, D]
    ctx = _context_dot(p_past, vcf)
    vhf = placed(vh.dequantize().data if isinstance(vh, QTensor)
                 else vh.data)
    ctx = ctx + torch.mul(*_promoted(p_self, vhf))
    if lead is not None:
        ctx = ctx[lead].contiguous()
    return [FTensor(ctx)]


def _reduce_mean(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    """ONNX ReduceMean: ``axes`` as input (opset 18) or attribute; the
    reference's ``axis`` spelling is accepted too, as in the JAX package."""
    x = inputs[0]
    if len(inputs) > 1 and inputs[1] is not None:
        axes = tuple(int(a) for a in inputs[1].data)
    elif "axes" in attrs:
        axes = tuple(int(a) for a in attrs["axes"])
    elif "axis" in attrs:
        axes = (int(attrs["axis"]),)
    else:
        axes = tuple(range(x.data.ndim))
    keepdims = bool(attrs.get("keepdims", 1))
    return [x.mean(axis=axes[0] if len(axes) == 1 else axes,
                   keepdims=keepdims)]


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
        # the packed kernels take int8 activations: a wider one takes the
        # exact int64 product of the unpacked weight
        if config.packed_execution == "kernel" and isinstance(a, QTensor) \
                and a.bit_width <= 8:
            return [_packed_matmul(a, b)]
        return [a.matmul(b.unpack())]
    if isinstance(a, FTensor) and isinstance(b, FTensor) \
            and a.data.ndim > 2 and b.data.ndim > 2 \
            and replays_xla(a.data, b.data):
        # a batched product of two activations (attention's scores and
        # context): XLA's CPU order (``_xla_cpu_dot``)
        return [FTensor(_xla_cpu_dot(a.data, b.data))]
    return [a.matmul(b)]


def _matmul_split(inputs: list[Tensor], attrs: dict) -> list[Tensor]:
    """One wide product against the horizontally concatenated weights of
    QModel.merge_parallel_matmuls, split back into the source products'
    outputs (JAX ``ops/registry.py:659-685``). Each segment keeps its
    source's scalar (s_x * s_w) float32 scale, so every value downstream
    equals the unmerged graph's. Under ``packed_execution == "kernel"`` a
    packed merged weight runs the packed kernel as an unmerged packed
    MatMul does, and the segments are its dequantized columns."""
    a, w = inputs[0], inputs[1]
    segments = [int(s) for s in attrs["segments"]]
    seg_scales = [np.float32(s) for s in attrs["segment_scales"]]
    if isinstance(w, PackedQTensor):
        if config.packed_execution == "kernel" and isinstance(a, QTensor) \
                and a.bit_width <= 8:
            y = _packed_matmul(a, w)
            bounds = np.cumsum([0] + segments)
            return [FTensor(y.data[..., s:e])
                    for s, e in zip(bounds[:-1], bounds[1:])]
        w = w.unpack()
    y = a.matmul(w)
    a_scale = np.float32(a.scale) if isinstance(a, QTensor) else None
    outs = []
    start = 0
    for n_i, s_i in zip(segments, seg_scales):
        sl = (Ellipsis, slice(start, start + n_i))
        if isinstance(y, QTensor):
            zp = y.zero_point
            if isinstance(zp, torch.Tensor) and zp.ndim > 0:
                zp = zp[sl]
            # the float32 product q_matmul computes for the unmerged dot
            outs.append(QTensor(y.data[sl], y.bit_width,
                                np.float32(a_scale * s_i), zp))
        else:
            outs.append(FTensor(y.data[sl]))
        start += n_i
    return outs


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
    if x.data.ndim == 3:
        return conv1d_op(inputs, attrs)
    if x.data.ndim != 4:
        raise NotImplementedError("Conv runs at 1 or 2 spatial dims")
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


def _constant(attrs: dict) -> list[Tensor]:
    value = attrs["value"]
    if value.dtype == np.float32:
        return [FTensor(attrs["placed"])]
    if value.dtype in (np.int64, np.int32):
        return [ITensor(value)]
    raise ValueError(f"Constant value dtype {value.dtype} not supported.")


# operand positions that set a static shape or axis: host values only
_HOST_OPERANDS = {
    "Reshape": (1,), "Expand": (1,), "Slice": (1, 2, 3, 4),
    "Unsqueeze": (1,), "Squeeze": (1,), "Split": (1,), "Tile": (1,),
    "Pad": (1, 3), "CumSum": (1,), "OneHot": (1,), "Trilu": (1,),
    "ConstantOfShape": (0,), "ReduceMean": (1,), "ReduceSum": (1,),
    "ReduceMax": (1,), "ReduceMin": (1,), "ReduceProd": (1,),
    "ReduceL1": (1,), "ReduceL2": (1,), "ReduceSumSquare": (1,),
    "ReduceLogSum": (1,), "ReduceLogSumExp": (1,), "Resize": (3,),
}


def onnx_operator_implementation(op: str, inputs: list[Tensor],
                                 attrs: dict[str, object]) -> list[Tensor]:
    """Run one op. A device integer (DITensor) where the op needs a host
    value (a target shape, axes, repeats) raises: reading it would stall
    the device and break a captured forward."""
    for i in _HOST_OPERANDS.get(op, ()):
        if i < len(inputs) and isinstance(inputs[i], DITensor):
            raise ValueError(
                f"{op} input {i} must be host-resident (shape domain): a "
                "device-computed value cannot set a static shape")
    if op == "Add":
        return [inputs[0] + inputs[1]]
    if op == "Concat":
        return [concat(list(inputs), axis=attrs["axis"])]
    if op == "Constant":
        return _constant(attrs)
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
        x, idx = inputs[0], inputs[1]
        axis = int(attrs.get("axis", 0))
        if isinstance(x, ITensor) and isinstance(idx, DITensor):
            # a host table gathered by device indices stays on the device
            table = place(x.data, idx.data.device, torch.int32)
            return [DITensor(_take(table, idx.data, axis))]
        return [x.take(idx, axis=axis)]
    if op == "Gemm":
        return _gemm(inputs, attrs)
    if op == "Identity":
        return [inputs[0].copy()]
    if op == "LayerNormalization":
        return _layer_norm(inputs, attrs)
    if op == "MatMul":
        return _matmul(inputs[0], inputs[1])
    if op == "MatMulSplit":
        return _matmul_split(inputs, attrs)
    if op == "Mul":
        return [inputs[0] * inputs[1]]
    if op == "Neg":
        return [-inputs[0]]
    if op == "ReduceMean":
        return _reduce_mean(inputs, attrs)
    if op == "Relu":
        return [inputs[0].relu()]
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
    if op == "Sigmoid":
        return [inputs[0].sigmoid()]
    if op == "Slice":
        return _slice(inputs)
    if op == "Softmax":
        return [inputs[0].softmax(axis=int(attrs.get("axis", -1)))]
    if op == "Split":
        return _split(inputs, attrs)
    if op == "Sqrt":
        return [inputs[0].sqrt()]
    if op == "Tanh":
        return [inputs[0].tanh()]
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
    if op == "DecodeAttention":
        return _decode_attention(inputs, attrs)
    if op == "FusedAttention":
        return _fused_attention(inputs, attrs)
    if op == "FusedAttentionHS":
        return _fused_attention_hs(inputs, attrs)
    if op == "FusedGelu":
        return _fused_gelu(inputs, attrs)
    if op in INTEROP_OPS:
        return INTEROP_OPS[op](inputs, attrs)
    if op in STANDARD_OPS:
        return STANDARD_OPS[op](inputs, attrs)
    if op in ("LSTM", "GRU"):
        return recurrent(op, inputs, attrs)
    raise NotImplementedError(f"ONNX op {op!r} is not ported")
