"""Fused int8 attention on the raw [B, N, H*D] Q/K/V projections, and on
pre-split [BH, N, D] heads.

Port of ``numpy_quant_tpu/kernels/attention.py::fused_attention_hs``, its
blockwise grid ``_fused_attention_hs_blockq``, and ``fused_attention`` (q
[BH, N, D], k^T [BH, D, N], v [BH, N, D]; exact f32 only): per head, in
one kernel launch,

    scores  = q_i8 @ k_i8^T            (int32, zero-point corrected)
    s       = dequant(scores) * scaling [+ score bias] [+ causal mask]
    probs   = softmax(s)               (f32)
    probs_q = quantize(probs)          (int8, the calibrated qparams)
    ctx     = probs_q @ v_i8           (int32, zero-point corrected)
    out     = dequant(ctx)             (f32, or int8 via out_requant)

``fast=False`` follows the unfused executor's float op order (the bf16
serving mode's ``fast=True`` folds log2(e) into the dequant constant,
uses exp2, an optional static ``score_max`` shift, drops the
softmax-invariant zk row term and elides provably dead clip bounds).
``causal_mask_val`` adds a decoder's dequantized mask constant above the
diagonal (outside the ``causal_window`` band, when one is given) at the
graph Add's position. ``score_bias`` ([H, nq, N] float32, head-split
forms only) adds a per-head score bias (T5's relative position bias, or
its decoder's bias + causal constant) at the graph Add's position too.

The exact forms sum each softmax row in the order of torch's CUDA sum
(:func:`sum_order`, replayed on the host by :func:`torch_order_sum`), so
that they equal the unfused executor bit for bit wherever torch reduces
the row in one warp (:func:`in_torch_order`).

``fused_attention_hs`` dispatches as the JAX wrapper does
(:func:`blockwise`): long sequences go to ``fused_attention_hs_blockq``,
the rest to the monolithic kernel. ``fused_attention`` runs one kernel at
any N. Each wrapper launches its hand-written CUDA kernel
(``csrc/attention_hs.cu``, ``csrc/attention_hs_blockq.cu``,
``csrc/attention_plain.cu``) on CUDA tensors, takes its plain PyTorch
version only for CPU tensors, and counts its kernel launches in its
``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import load

KERNEL_DIMS = (16, 32, 64, 128)  # head dims the kernels are built for
_MAX_SMEM = 232448              # bytes of shared memory a block may use
# JAX's _BLOCKWISE_N: at round_up(N, 128) >= this the blockwise grid runs
BLOCKWISE_N = 1024
BLOCK_Q = 256  # q rows per tile of the blockwise plain version (JAX's default)
# the blockwise kernel's centred int32 context sum is bounded by 255^2 * N
MAX_BLOCKQ_N = 33000
# JAX's score-bias clause: a padded f32 bias block above this runs blockwise
BIAS_BYTES = 2 * 1024 * 1024
LOG2E = np.float32(np.log2(np.e))


class _PlainParams(ctypes.Structure):
    """Mirror of ``PlainParams`` in csrc/attention_plain.cu."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "BH", "N", "D", "zq", "zk", "zv", "zp_p", "out_int8", "has_res_zp",
        "causal", "window", "skip", "sum_vec", "sum_lanes", "sum_tile")] \
        + [(name, ctypes.c_float) for name in (
            "c_score", "scaling", "sp", "zp_pf", "c_out", "res_scale",
            "res_zp", "qmin", "qmax", "mask")]


class _HSParams(ctypes.Structure):
    """Mirror of ``HSParams`` in csrc/attention_hs.cu and
    csrc/attention_hs_blockq.cu."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "nq", "N", "H", "D", "zq", "zk", "zv", "zp_p", "fast",
        "static_shift", "need_lo", "need_hi", "out_int8", "has_res_zp",
        "causal", "window", "skip", "has_bias", "sum_vec", "sum_lanes",
        "sum_tile")] \
        + [(name, ctypes.c_float) for name in (
            "c_score", "scaling", "czq", "base", "sp", "zp_pf", "c_out",
            "res_scale", "res_zp", "qmin", "qmax", "mask")]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plain_tile(n: int) -> int:
    """Query rows per tile of :func:`fused_attention_reference` at ``n``
    keys: JAX's 256-row tiles on its blockwise grid, else all rows."""
    return BLOCK_Q if blockwise(n, None) else n


def blockwise(n: int, block_q: int | None, nq: int | None = None,
              bias_heads: int | None = None) -> bool:
    """True when a call with ``n`` keys (and ``nq`` query rows, default
    ``n``) runs the blockwise grid, as JAX's wrapper decides
    (``kernels/attention.py:432-446``): a forced ``block_q``, at least
    BLOCKWISE_N keys once padded to 128 lanes, or a score bias of
    ``bias_heads`` heads whose padded f32 block passes 2 MiB."""
    if block_q is not None or _round_up(n, 128) >= BLOCKWISE_N:
        return True
    rows = n if nq is None else nq
    return bias_heads is not None \
        and bias_heads * _round_up(rows, 8) * _round_up(n, 128) * 4 > BIAS_BYTES


def _constants(*, scaling, sq, zq, sk, sv, sp, zp_p, bit_width,
               out_requant, fast, score_max, causal_mask_val=None,
               **_) -> dict:
    """The float32 constants of the kernel, computed with the same f32
    operations as the JAX kernel (``_attention_hs_kernel``). The
    wrappers' other keyword arguments are ignored."""
    f32 = np.float32
    sq, sk, sv, sp, scaling = f32(sq), f32(sk), f32(sv), f32(sp), f32(scaling)
    qmin = -2.0 ** (bit_width - 1)
    qmax = 2.0 ** (bit_width - 1) - 1.0
    c = {"qmin": qmin, "qmax": qmax, "sp": sp, "zp_pf": f32(zp_p),
         "scaling": scaling, "c_out": f32(sp * sv), "mask": f32(0.0)}
    log2e = LOG2E
    if fast:
        c2 = f32(f32(sq * sk) * scaling * log2e)
        c["c_score"] = c2
        c["czq"] = f32(f32(-zq) * c2)
        c["static_shift"] = score_max is not None
        c["base"] = f32(0.0) if score_max is None \
            else -f32(f32(score_max) * log2e)
        # probs lie in [0, 1]: drop each clip bound the calibrated
        # (sp, zp) provably cannot cross (0.3 covers the f32 error)
        c["need_lo"] = bool(zp_p < qmin)
        c["need_hi"] = bool(f32(1.0) / sp + zp_p > qmax - 0.3)
    else:
        c["c_score"] = f32(sq * sk)
        c["czq"] = f32(0.0)
        c["base"] = f32(0.0)
        c["static_shift"] = False
        c["need_lo"] = c["need_hi"] = True
    if causal_mask_val is not None:
        # the fast path works in the exp2 domain: the mask scales by log2(e)
        c["mask"] = f32(f32(causal_mask_val) * log2e) if fast \
            else f32(causal_mask_val)
    c["res_scale"] = f32(1.0)
    c["res_zp"] = None
    if out_requant is not None:
        res_scale, res_zp = out_requant
        c["res_scale"] = f32(res_scale)
        c["res_zp"] = None if res_zp is None else f32(res_zp)
        if fast:
            c["c_out"] = f32(f32(sp * sv) / f32(res_scale))
    return c


def _int_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 batched product of int8-valued tensors (float64 holds
    every partial sum exactly)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)) \
        .to(torch.int32)


def _divide(x: torch.Tensor, divisor) -> torch.Tensor:
    """IEEE x / divisor (a 0-d device tensor, never a host scalar)."""
    return x / torch.full((), float(divisor), dtype=torch.float32,
                          device=x.device)


def _mask_add(rows: torch.Tensor, n: int, mask, causal_window):
    """[rows, n] f32: 0 where key j is visible from query row i (j <= i,
    and j > i - causal_window with a band), ``mask`` elsewhere."""
    j = torch.arange(n, device=rows.device)[None, :]
    i = rows[:, None]
    visible = j <= i
    if causal_window is not None:
        visible = visible & (j > i - int(causal_window))
    return torch.where(visible, torch.zeros((), device=rows.device),
                       torch.full((), float(mask), device=rows.device))


def fused_attention_hs_blockq_reference(xq, xk, xv, *, num_heads: int,
                                        scaling: float, sq: float, zq: int,
                                        sk: float, zk: int, sv: float,
                                        zv: int, sp: float, zp_p: int,
                                        bit_width: int = 8,
                                        out_requant: tuple | None = None,
                                        fast: bool = False,
                                        score_max: float | None = None,
                                        causal_mask_val: float | None = None,
                                        causal_window: int | None = None,
                                        score_bias: torch.Tensor | None = None,
                                        block_q: int | None = BLOCK_Q):
    """Plain PyTorch version of the blockwise kernel: q rows in tiles of
    ``block_q`` (all rows in one tile when None), each tile's full rows
    in the JAX kernel's op order, so memory grows with block_q * N. The
    ``score_bias`` rows [H, rows, N] follow the q tiles."""
    k = _constants(scaling=scaling, sq=sq, zq=zq, sk=sk, sv=sv, sp=sp,
                   zp_p=zp_p, bit_width=bit_width, out_requant=out_requant,
                   fast=fast, score_max=score_max,
                   causal_mask_val=causal_mask_val)
    b, nq, hd = xq.shape
    n = xk.shape[1]
    d = hd // num_heads
    i32 = torch.int32

    def heads(x, rows):  # [B, rows, H*D] -> [B, H, rows, D] int32
        return x.reshape(b, rows, num_heads, d).permute(0, 2, 1, 3).to(i32)

    q_all, kk, v = heads(xq, nq), heads(xk, n), heads(xv, n)
    ksum = kk.sum(dim=-1, dtype=i32)[:, :, None, :]  # [B, H, 1, N]
    vsum = v.sum(dim=-2, keepdim=True, dtype=i32)   # [B, H, 1, D]
    kt = kk.transpose(-1, -2)
    if score_bias is not None and fast:
        # the fast path works in the exp2 domain
        score_bias = score_bias * float(LOG2E)
    tiles = []
    step = max(1, nq if block_q is None else int(block_q))
    for r0 in range(0, max(nq, 1), step):  # one (empty) tile when nq == 0
        q = q_all[:, :, r0:r0 + step]
        raw = _int_bmm(q, kt)  # [B, H, rows, N]
        mask = None
        if causal_mask_val is not None:
            rows = torch.arange(r0, r0 + q.shape[2], device=raw.device)
            mask = _mask_add(rows, n, k["mask"], causal_window)
        if fast:
            if zq != 0:
                percol = ksum.to(torch.float32) * float(k["czq"]) \
                    + float(k["base"])
            else:
                percol = torch.full((), float(k["base"]), device=raw.device)
            s = raw.to(torch.float32) * float(k["c_score"]) + percol
            if score_bias is not None:
                s = s + score_bias[None, :, r0:r0 + step]
            if mask is not None:
                s = s + mask
            if k["static_shift"]:
                e = torch.exp2(torch.clamp(s, -120.0, 80.0))
            else:
                e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
            r = torch.ones((), device=e.device) \
                / (e.sum(dim=-1, keepdim=True) * float(k["sp"]))
            pq = e * r + float(k["zp_pf"])
            if k["need_lo"] or k["need_hi"]:
                pq = torch.clamp(pq, k["qmin"] if k["need_lo"] else None,
                                 k["qmax"] if k["need_hi"] else None)
            pq = torch.round(pq).to(torch.int8)
        else:
            scores = raw
            if zk != 0:
                scores = scores - q.sum(dim=-1, keepdim=True, dtype=i32) * zk
            if zq != 0:
                scores = scores - ksum * zq
            if zq != 0 and zk != 0:
                scores = scores + zq * zk * d
            s = scores.to(torch.float32) * float(k["c_score"])
            s = s * float(k["scaling"])
            if score_bias is not None:
                s = s + score_bias[None, :, r0:r0 + step]
            if mask is not None:
                s = s + mask
            m = s.amax(dim=-1, keepdim=True)
            e = torch.exp(s - m)
            probs = e / e.sum(dim=-1, keepdim=True)
            pq = torch.round(torch.clamp(
                _divide(probs, k["sp"]) + float(k["zp_pf"]),
                k["qmin"], k["qmax"])).to(torch.int8)

        p32 = pq.to(i32)
        ctx = _int_bmm(p32, v)  # [B, H, rows, D]
        if zv != 0:
            ctx = ctx - p32.sum(dim=-1, keepdim=True, dtype=i32) * zv
        if zp_p != 0:
            ctx = ctx - vsum * zp_p
        if zp_p != 0 and zv != 0:
            ctx = ctx + zp_p * zv * n
        y = ctx.to(torch.float32) * float(k["c_out"])
        if out_requant is not None:
            yq = y if fast else _divide(y, k["res_scale"])
            if k["res_zp"] is not None:
                yq = yq + float(k["res_zp"])
            y = torch.round(torch.clamp(yq, k["qmin"], k["qmax"])) \
                .to(torch.int8)
        tiles.append(y)
    y = torch.cat(tiles, dim=2) if len(tiles) > 1 else tiles[0]
    return y.permute(0, 2, 1, 3).reshape(b, nq, hd)


def fused_attention_hs_reference(xq, xk, xv, *, num_heads: int,
                                 scaling: float, sq: float, zq: int,
                                 sk: float, zk: int, sv: float, zv: int,
                                 sp: float, zp_p: int, bit_width: int = 8,
                                 out_requant: tuple | None = None,
                                 fast: bool = False,
                                 score_max: float | None = None,
                                 causal_mask_val: float | None = None,
                                 causal_window: int | None = None,
                                 score_bias: torch.Tensor | None = None):
    """Plain PyTorch version of the monolithic kernel, each head
    independent, in the same op order as the JAX kernel's variant: the
    blockwise plain version with all rows in one tile."""
    return fused_attention_hs_blockq_reference(
        xq, xk, xv, num_heads=num_heads, scaling=scaling, sq=sq, zq=zq,
        sk=sk, zk=zk, sv=sv, zv=zv, sp=sp, zp_p=zp_p, bit_width=bit_width,
        out_requant=out_requant, fast=fast, score_max=score_max,
        causal_mask_val=causal_mask_val, causal_window=causal_window,
        score_bias=score_bias, block_q=None)


def _check(xq, xk, xv, num_heads, causal_mask_val, score_bias=None):
    for t in (xq, xk, xv):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int8:
            raise TypeError("fused_attention_hs takes int8 tensors")
        if t.ndim != 3:
            raise ValueError(f"expected [B, N, H*D] tensors, got {tuple(t.shape)}")
        if t.device != xq.device:
            raise ValueError("q, k and v must lie on one device")
    b, nq, hd = xq.shape
    if xk.shape != xv.shape or xk.shape[0] != b or xk.shape[2] != hd:
        raise ValueError(f"shapes q {tuple(xq.shape)}, k {tuple(xk.shape)}, "
                         f"v {tuple(xv.shape)} do not match")
    if nq > xk.shape[1]:
        raise ValueError(f"{nq} query rows exceed {xk.shape[1]} keys")
    if hd % num_heads:
        raise ValueError(f"H*D={hd} is not divisible by {num_heads} heads")
    # a causal mask indexes q rows by absolute position (JAX asserts it)
    if causal_mask_val is not None and nq != xk.shape[1]:
        raise ValueError(f"a causal mask needs all {xk.shape[1]} query "
                         f"rows, got {nq}")
    if score_bias is None:
        return
    # a bias indexes q rows by absolute position too (JAX asserts nq == N)
    if nq != xk.shape[1]:
        raise ValueError(f"a score bias needs all {xk.shape[1]} query "
                         f"rows, got {nq}")
    want = (num_heads, nq, xk.shape[1])
    if not isinstance(score_bias, torch.Tensor) \
            or score_bias.dtype != torch.float32 \
            or tuple(score_bias.shape) != want \
            or score_bias.device != xq.device:
        raise ValueError(f"score_bias must be a float32 {list(want)} tensor "
                         f"on {xq.device}")


def _launch_checks(xq, xk, xv, num_heads, name):
    """Device, head dim and layout checks before a kernel launch; returns
    the head dim."""
    if xq.device.type != "cuda":
        raise ValueError(f"no {name} for device {xq.device}")
    d = xq.shape[2] // num_heads
    if d not in KERNEL_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_DIMS}")
    for t in (xq, xk, xv):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous, 16-byte aligned "
                             "tensors")
    return d


def _launch(wrapper, name: str, xq, xk, xv, d: int, c: dict, kw: dict,
            skip: bool = False, sum_tile: int | None = None) -> torch.Tensor:
    """Launch ``csrc/<name>.cu`` on the current stream with the wrapper's
    keyword arguments ``kw`` (its ``score_bias`` already in the form's
    domain) and their constants ``c``; counts the launch in
    ``wrapper.launches``. ``sum_tile`` is the plain version's q tile rows
    (default: all rows), which set each exact row's alignment in torch's
    sum order."""
    out = torch.empty(xq.shape, device=xq.device,
                      dtype=torch.float32 if kw["out_requant"] is None
                      else torch.int8)
    if out.numel() == 0:
        return out
    b, nq, _ = xq.shape
    n = xk.shape[1]
    window = kw["causal_window"]
    bias = kw["score_bias"]
    vec, lanes = sum_order(n)
    p = _HSParams(
        B=b, nq=nq, N=n, H=kw["num_heads"], D=d, zq=int(kw["zq"]),
        zk=int(kw["zk"]), zv=int(kw["zv"]), zp_p=int(kw["zp_p"]),
        fast=int(kw["fast"]), static_shift=int(c["static_shift"]),
        need_lo=int(c["need_lo"]), need_hi=int(c["need_hi"]),
        out_int8=int(kw["out_requant"] is not None),
        has_res_zp=int(c["res_zp"] is not None),
        causal=int(kw["causal_mask_val"] is not None),
        window=0 if window is None else int(window), skip=int(skip),
        has_bias=int(bias is not None), sum_vec=int(vec), sum_lanes=lanes,
        sum_tile=max(1, int(sum_tile or nq)), c_score=c["c_score"],
        scaling=c["scaling"], czq=c["czq"],
        base=c["base"], sp=c["sp"], zp_pf=c["zp_pf"], c_out=c["c_out"],
        res_scale=c["res_scale"],
        res_zp=0.0 if c["res_zp"] is None else c["res_zp"],
        qmin=c["qmin"], qmax=c["qmax"], mask=c["mask"])
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = getattr(_library(name, _HSParams), f"nq_{name}")(
        xq.data_ptr(), xk.data_ptr(), xv.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def _kernel_bias(score_bias, fast: bool):
    """The bias as the kernels read it: contiguous, and scaled by log2(e)
    once per call on the fast path (its exp2 domain), as the plain
    versions scale it."""
    if score_bias is None:
        return None
    return (score_bias * float(LOG2E) if fast else score_bias).contiguous()


def fused_attention_hs(xq, xk, xv, *, num_heads: int, scaling: float,
                       sq: float, zq: int, sk: float, zk: int, sv: float,
                       zv: int, sp: float, zp_p: int, bit_width: int = 8,
                       out_requant: tuple | None = None, fast: bool = False,
                       score_max: float | None = None,
                       causal_mask_val: float | None = None,
                       causal_window: int | None = None,
                       score_bias: torch.Tensor | None = None,
                       block_q: int | None = None):
    """xq [B, nq, H*D], xk/xv [B, N, H*D] int8 (nq <= N: narrow q runs
    fewer query rows against full K/V; a causal mask or a score bias
    needs nq == N). ``score_bias``: float32 [H, nq, N], added to the
    scaled scores of each batch row. Returns [B, nq, H*D] float32, or
    int8 with ``out_requant=(scale, zero_point)``.

    Long sequences and large biases (see :func:`blockwise`) go to
    :func:`fused_attention_hs_blockq`, the rest to
    :func:`fused_attention_hs_monolithic`."""
    _check(xq, xk, xv, num_heads, causal_mask_val, score_bias)
    kw = dict(num_heads=num_heads, scaling=scaling, sq=sq, zq=zq, sk=sk,
              zk=zk, sv=sv, zv=zv, sp=sp, zp_p=zp_p, bit_width=bit_width,
              out_requant=out_requant, fast=fast, score_max=score_max,
              causal_mask_val=causal_mask_val, causal_window=causal_window,
              score_bias=score_bias)
    if blockwise(xk.shape[1], block_q, nq=xq.shape[1],
                 bias_heads=None if score_bias is None else num_heads):
        return fused_attention_hs_blockq(xq, xk, xv, block_q=block_q or BLOCK_Q,
                                         **kw)
    return fused_attention_hs_monolithic(xq, xk, xv, **kw)


fused_attention_hs.launches = 0  # launches of the monolithic kernel


def fused_attention_hs_monolithic(xq, xk, xv, *, num_heads: int,
                                  scaling: float, sq: float, zq: int,
                                  sk: float, zk: int, sv: float, zv: int,
                                  sp: float, zp_p: int, bit_width: int = 8,
                                  out_requant: tuple | None = None,
                                  fast: bool = False,
                                  score_max: float | None = None,
                                  causal_mask_val: float | None = None,
                                  causal_window: int | None = None,
                                  score_bias: torch.Tensor | None = None):
    """The monolithic kernel whatever N (up to its shared memory): CUDA
    tensors launch ``csrc/attention_hs.cu`` (or raise), counted in
    ``fused_attention_hs.launches``; CPU tensors take
    ``fused_attention_hs_reference``."""
    _check(xq, xk, xv, num_heads, causal_mask_val, score_bias)
    kw = dict(num_heads=num_heads, scaling=scaling, sq=sq, zq=zq, sk=sk,
              zk=zk, sv=sv, zv=zv, sp=sp, zp_p=zp_p, bit_width=bit_width,
              out_requant=out_requant, fast=fast, score_max=score_max,
              causal_mask_val=causal_mask_val, causal_window=causal_window,
              score_bias=score_bias)
    if xq.device.type == "cpu":
        return fused_attention_hs_reference(xq, xk, xv, **kw)
    n = xk.shape[1]
    d = _launch_checks(xq, xk, xv, num_heads, "fused_attention_hs")
    if _library("attention_hs", _HSParams).nq_attention_hs_smem_bytes(n, d) \
            > _MAX_SMEM:
        raise ValueError(f"N={n} keys at head dim {d} exceed the shared "
                         "memory of one block")
    c = _constants(**kw)
    kw["score_bias"] = _kernel_bias(score_bias, fast)
    return _launch(fused_attention_hs, "attention_hs", xq, xk, xv, d, c, kw)


def skips_masked_tiles(d: int, **kw) -> bool:
    """Whether :func:`fused_attention`'s kernel skips the key tiles masked
    for every row of a block, for a call with keyword arguments ``kw`` at
    head dim ``d``."""
    if kw.get("causal_mask_val") is None:
        return False
    return _skip_masked_tiles(_constants(fast=False, score_max=None, **kw), d,
                              False)


def _skip_masked_tiles(c: dict, d: int, fast: bool) -> bool:
    """True when every masked score provably leaves nothing behind, so the
    blockwise kernel may skip key tiles that are masked for all of its
    rows: exp(s + mask - m) is exactly 0 (exact path), exp2 of it is 0
    (fast path), or it clamps to 2^-120 (static shift, which the kernel
    adds in closed form). |s| <= S = 255^2 * D * |score constant| +
    |base| before the mask, so s_j - m <= 2S; a margin of 256 covers exp,
    exp2 and the clamp with room for f32 rounding. A score bias is not
    in that bound, so a call with one never skips."""
    scale = abs(float(c["c_score"])) * (1.0 if fast else abs(float(c["scaling"])))
    bound = 255.0 * 255.0 * d * scale + abs(float(c["base"]))
    return float(c["mask"]) < -(2.0 * bound + 256.0)


def fused_attention_hs_blockq(xq, xk, xv, *, num_heads: int, scaling: float,
                              sq: float, zq: int, sk: float, zk: int,
                              sv: float, zv: int, sp: float, zp_p: int,
                              bit_width: int = 8,
                              out_requant: tuple | None = None,
                              fast: bool = False,
                              score_max: float | None = None,
                              causal_mask_val: float | None = None,
                              causal_window: int | None = None,
                              score_bias: torch.Tensor | None = None,
                              block_q: int = BLOCK_Q):
    """The blockwise form of :func:`fused_attention_hs` for long
    sequences: the same function of the same operands. CUDA tensors
    launch ``csrc/attention_hs_blockq.cu`` (or raise), which streams K/V
    (and the bias rows of its q tile) through shared memory in tiles, so
    N is bounded only by its int32 context sums (MAX_BLOCKQ_N); CPU
    tensors take ``fused_attention_hs_blockq_reference`` with q tiles of
    ``block_q`` rows (the kernel's own tiles are fixed)."""
    _check(xq, xk, xv, num_heads, causal_mask_val, score_bias)
    kw = dict(num_heads=num_heads, scaling=scaling, sq=sq, zq=zq, sk=sk,
              zk=zk, sv=sv, zv=zv, sp=sp, zp_p=zp_p, bit_width=bit_width,
              out_requant=out_requant, fast=fast, score_max=score_max,
              causal_mask_val=causal_mask_val, causal_window=causal_window,
              score_bias=score_bias)
    if xq.device.type == "cpu":
        return fused_attention_hs_blockq_reference(xq, xk, xv,
                                                   block_q=block_q, **kw)
    d = _launch_checks(xq, xk, xv, num_heads, "fused_attention_hs_blockq")
    n = xk.shape[1]
    if n > MAX_BLOCKQ_N:
        raise ValueError(f"N={n} keys exceed {MAX_BLOCKQ_N}: the int32 "
                         "context sum could overflow")
    c = _constants(**kw)
    skip = causal_mask_val is not None and score_bias is None \
        and _skip_masked_tiles(c, d, fast)
    kw["score_bias"] = _kernel_bias(score_bias, fast)
    return _launch(fused_attention_hs_blockq, "attention_hs_blockq", xq, xk,
                   xv, d, c, kw, skip=skip, sum_tile=block_q)


fused_attention_hs_blockq.launches = 0


# -- torch's CUDA row-sum order ---------------------------------------------
#
# torch sums a contiguous [rows, N] float32 tensor over its last dim in
# ATen's Reduce.cuh order: each row in one warp of up to 32 lanes (while
# rows and N leave it so), each lane adding into 4 accumulators -- 4-vector
# loads from N >= 128 on (the row's unaligned head and tail elements apart),
# strided scalar loads below -- combined ((a0 + a1) + a2) + a3, then a
# shfl_down lane tree with offsets lanes/2..1. The exact kernels add each
# softmax row in that order (csrc/torch_order.cuh).

TORCH_VEC_N = 128  # torch vectorizes the row loads from this many keys on


def _last_pow2(x: int) -> int:
    return 1 << (max(1, int(x)).bit_length() - 1)


def sum_order(n: int) -> tuple[bool, int]:
    """(vectorized loads, lanes) of the one-warp row sum over ``n`` keys
    that the exact kernels replay."""
    vec = n >= TORCH_VEC_N
    return vec, min(32, _last_pow2(n // 4 if vec else n))


def in_torch_order(rows: int, n: int) -> bool:
    """True when torch reduces each row of a contiguous [rows, n] float32
    tensor in one warp as :func:`sum_order` says (Reduce.cuh's block shape:
    at most 512 threads, and no split of a row across warps), so that the
    exact kernels' row sums equal torch's."""
    vec, lanes = sum_order(n)
    p0 = min(_last_pow2(n // 4 if vec else n), 512)
    p1 = min(_last_pow2(rows), 512)
    width = min(p0, 32)
    height = min(p1, 512 // width)
    width = min(p0, 512 // height)
    return width == lanes and -(-n // width) < min(height * 16, 256)


def torch_order_sum(x: np.ndarray, row_ids=None) -> np.ndarray:
    """The row sums of x [rows, N] float32 in the kernels' order (torch's,
    where :func:`in_torch_order`), replayed on the host. ``row_ids`` are
    the rows' indices in the summed tensor (default 0..rows-1): when N % 4
    != 0 a row's misalignment, (row * N) % 4 elements, decides which
    elements its head and tail hold."""
    x = np.asarray(x, np.float32)
    rows, n = x.shape
    vec, lanes = sum_order(n)
    ids = np.arange(rows) if row_ids is None else np.asarray(row_ids)
    acc = np.zeros((rows, lanes, 4), np.float32)
    if not vec:
        # lane L, accumulator i adds keys L + i*lanes + 4*lanes*k in order
        padded = np.zeros((rows, _round_up(n, 4 * lanes)), np.float32)
        padded[:, :n] = x
        for k in range(0, padded.shape[1], 4 * lanes):
            acc += padded[:, k:k + 4 * lanes].reshape(rows, 4, lanes) \
                .transpose(0, 2, 1)
    else:
        shift = (ids.astype(np.int64) * n) % 4
        for s in range(4):
            sel = np.nonzero(shift == s)[0]
            if sel.size == 0:
                continue
            xs, a = x[sel], np.zeros((sel.size, lanes, 4), np.float32)
            start, end = 0, n
            if s:
                # the unaligned head: lanes s..3 take elements 0..3-s
                for lane in range(s, 4):
                    a[:, lane, 0] = xs[:, lane - s]
                start, end = 4 - s, n + s - 4
            nvec = end // 4
            body = np.zeros((sel.size, _round_up(nvec, lanes) * 4), np.float32)
            body[:, :nvec * 4] = xs[:, start:start + nvec * 4]
            for k in range(0, body.shape[1], 4 * lanes):
                a += body[:, k:k + 4 * lanes].reshape(sel.size, lanes, 4)
            # the tail: lane L takes element L after the last full vector
            for lane in range(end % 4):
                a[:, lane, 0] += xs[:, start + nvec * 4 + lane]
            acc[sel] = a
    v = ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    return v[:, 0]


def torch_sums_in_kernel_order(device, rows: int = 64, n: int = 1024) -> bool:
    """True when torch's sum over the last dim of a [rows, n] float32
    tensor on ``device`` adds in the order the exact kernels' softmax row
    sums take: seeded rows summed there and replayed on the host (at most
    the first and last 256 rows). The kernels equal the unfused executor
    bit for bit only at shapes where this holds; a torch whose reduction
    order changed makes it False."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((rows, n), generator=gen, device=device)
    got = x.sum(dim=-1)
    ids = np.unique(np.r_[np.arange(min(rows, 256)),
                          np.arange(max(0, rows - 256), rows)])
    sel = torch.from_numpy(ids).to(device)
    want = torch_order_sum(x[sel].cpu().numpy(), row_ids=ids)
    return bool(np.array_equal(got[sel].cpu().numpy(), want))


def fused_attention_reference(q, kt, v, *, scaling: float, sq: float,
                              zq: int, sk: float, zk: int, sv: float,
                              zv: int, sp: float, zp_p: int,
                              bit_width: int = 8,
                              out_requant: tuple | None = None,
                              causal_mask_val: float | None = None,
                              causal_window: int | None = None,
                              block_q: int | None = None):
    """Plain PyTorch version of :func:`fused_attention`, in the op order of
    JAX's ``_attention_kernel`` over the real keys (the TPU's pad keys add
    nothing: their score is -inf, so their quantized probability is zp_p,
    and v's pad rows hold zv). q rows run in tiles of ``block_q`` rows
    (default: JAX's 256-row tiles at N >= 1024, else one tile); rows are
    independent, so the tiling changes no bit."""
    c = _constants(scaling=scaling, sq=sq, zq=zq, sk=sk, sv=sv, sp=sp,
                   zp_p=zp_p, bit_width=bit_width, out_requant=out_requant,
                   fast=False, score_max=None,
                   causal_mask_val=causal_mask_val)
    bh, n, d = q.shape
    i32 = torch.int32
    qi, kti, vi = q.to(i32), kt.to(i32), v.to(i32)
    ksum = kti.sum(dim=1, keepdim=True, dtype=i32)  # [BH, 1, N]
    vsum = vi.sum(dim=1, keepdim=True, dtype=i32)   # [BH, 1, D]
    if block_q is None:
        block_q = plain_tile(n)
    step = max(1, int(block_q))
    tiles = []
    for r0 in range(0, max(n, 1), step):  # one (empty) tile when n == 0
        qt = qi[:, r0:r0 + step]
        scores = _int_bmm(qt, kti)  # [BH, rows, N]
        corr = None
        if zk != 0:
            corr = qt.sum(dim=-1, keepdim=True, dtype=i32) * zk
        if zq != 0:
            t = ksum * zq
            corr = t if corr is None else corr + t
        if zq != 0 and zk != 0:
            corr = corr - zq * zk * d
        if corr is not None:
            scores = scores - corr
        s = scores.to(torch.float32) * float(c["c_score"])
        s = s * float(c["scaling"])
        if causal_mask_val is not None:
            rows = torch.arange(r0, r0 + qt.shape[1], device=s.device)
            s = s + _mask_add(rows, n, c["mask"], causal_window)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
        pq = torch.round(torch.clamp(
            _divide(probs, c["sp"]) + float(c["zp_pf"]),
            c["qmin"], c["qmax"])).to(i32)
        ctx = _int_bmm(pq, vi)  # [BH, rows, D]
        if zv != 0:
            ctx = ctx - pq.sum(dim=-1, keepdim=True, dtype=i32) * zv
        if zp_p != 0:
            ctx = ctx - vsum * zp_p
        if zp_p != 0 and zv != 0:
            ctx = ctx + zp_p * zv * n
        y = ctx.to(torch.float32) * float(c["c_out"])
        if out_requant is not None:
            yq = _divide(y, c["res_scale"])
            if c["res_zp"] is not None:
                yq = yq + float(c["res_zp"])
            y = torch.round(torch.clamp(yq, c["qmin"], c["qmax"])) \
                .to(torch.int8)
        tiles.append(y)
    return torch.cat(tiles, dim=1) if len(tiles) > 1 else tiles[0]


def fused_attention(q, kt, v, *, scaling: float, sq: float, zq: int,
                    sk: float, zk: int, sv: float, zv: int, sp: float,
                    zp_p: int, bit_width: int = 8,
                    out_requant: tuple | None = None,
                    causal_mask_val: float | None = None,
                    causal_window: int | None = None):
    """Pre-split int8 attention: q [BH, N, D], kt [BH, D, N] (keys
    transposed), v [BH, N, D], all int8. Returns [BH, N, D] float32, or
    int8 with ``out_requant=(scale, zero_point)``. Exact f32 only (JAX's
    ``fused_attention`` has no fast form). CUDA tensors launch
    ``csrc/attention_plain.cu`` (or raise), counted in
    ``fused_attention.launches``; CPU tensors take
    ``fused_attention_reference``. The kernel sums each softmax row in
    torch's CUDA order (csrc/torch_order.cuh) for the plain version's
    softmax tensor, [BH, q tile rows, N], so wherever
    ``in_torch_order(BH * rows, N)`` holds for its q tiles it equals the
    plain version bit for bit."""
    for t in (q, kt, v):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int8:
            raise TypeError("fused_attention takes int8 tensors")
        if t.ndim != 3:
            raise ValueError(f"expected rank-3 tensors, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("q, kt and v must lie on one device")
    bh, n, d = q.shape
    if tuple(kt.shape) != (bh, d, n) or tuple(v.shape) != (bh, n, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, kt {tuple(kt.shape)}, "
                         f"v {tuple(v.shape)} are not [BH, N, D], [BH, D, N], "
                         "[BH, N, D]")
    kw = dict(scaling=scaling, sq=sq, zq=zq, sk=sk, zk=zk, sv=sv, zv=zv,
              sp=sp, zp_p=zp_p, bit_width=bit_width, out_requant=out_requant,
              causal_mask_val=causal_mask_val, causal_window=causal_window)
    if q.device.type == "cpu":
        return fused_attention_reference(q, kt, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no fused_attention for device {q.device}")
    if d not in KERNEL_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_DIMS}")
    if n > MAX_BLOCKQ_N:
        raise ValueError(f"N={n} keys exceed {MAX_BLOCKQ_N}: the int32 "
                         "context sum could overflow")
    for t in (q, kt, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_attention needs contiguous, 16-byte "
                             "aligned tensors")
    out = torch.empty(q.shape, device=q.device,
                      dtype=torch.float32 if out_requant is None
                      else torch.int8)
    if out.numel() == 0:
        return out
    c = _constants(fast=False, score_max=None, **kw)
    vec, lanes = sum_order(n)
    p = _PlainParams(
        BH=bh, N=n, D=d, zq=int(zq), zk=int(zk), zv=int(zv), zp_p=int(zp_p),
        out_int8=int(out_requant is not None),
        has_res_zp=int(c["res_zp"] is not None),
        causal=int(causal_mask_val is not None),
        window=0 if causal_window is None else int(causal_window),
        skip=int(skips_masked_tiles(d, **kw)),
        sum_vec=int(vec), sum_lanes=lanes, sum_tile=max(1, plain_tile(n)),
        c_score=c["c_score"], scaling=c["scaling"], sp=c["sp"],
        zp_pf=c["zp_pf"], c_out=c["c_out"], res_scale=c["res_scale"],
        res_zp=0.0 if c["res_zp"] is None else c["res_zp"],
        qmin=c["qmin"], qmax=c["qmax"], mask=c["mask"])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _library("attention_plain", _PlainParams).nq_attention_plain(
        q.data_ptr(), kt.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"attention_plain kernel launch failed: CUDA "
                           f"error {rc}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def _library(name: str, params: type[ctypes.Structure]) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded, its ``nq_<name>`` entry typed
    to take ``params`` by pointer."""
    lib = load(name)
    if not getattr(lib, "_nq_typed", False):
        fn = getattr(lib, f"nq_{name}")
        # q, k (or k^T), v, [the score bias,] out
        pointers = 4 if params is _PlainParams else 5
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.POINTER(params),
                                                      ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if name == "attention_hs":
            lib.nq_attention_hs_smem_bytes.argtypes = [ctypes.c_int,
                                                       ctypes.c_int]
            lib.nq_attention_hs_smem_bytes.restype = ctypes.c_longlong
        lib._nq_typed = True
    return lib
