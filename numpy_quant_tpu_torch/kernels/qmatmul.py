"""Fused matmuls over packed weights.

Port of ``numpy_quant_tpu/kernels/qmatmul.py::splitk_qmatmul``,
``::packed_qmatmul`` and ``::splitk_wo_matmul``. The first two compute,
for x [M, K] and a packed b-bit
symmetric weight W [K, N] with column sums colsum [1, N],

    xq  = quantize(x)             (quantize_x=True: divide, +zp, clip, rint)
          or x as int8            (quantize_x=False: already quantized)
    acc = xq @ unpack(W)          (int32, exact)
    acc = acc - colsum * x_zp     (int32, when x has a zero point)
    y   = f32(acc) * scale_row    (scale_row = f32(x_scale) * f32(w_scale[n]))
    y   = y + bias                (optional)
    out = y, or int8 clip(rint(y * f32(1/res_scale) + res_zp))   (out_requant)

``splitk_qmatmul`` reads the split-K layout (int8 [K, N] at 8 bits,
uint8 [ceil(K/r), N] at 1/2/4 bits); ``packed_qmatmul`` reads bit-planes
uint8 [b, ceil(K/8), N] at any width 1..8 (kernels/pack.py).

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/qmatmul.cu`` (or raise); on CPU tensors they take the plain
PyTorch versions ``splitk_qmatmul_reference`` / ``packed_qmatmul_reference``.
Each wrapper's ``launches`` attribute counts its kernel launches. Every
epilogue step rounds once, as in the JAX kernels, so kernel and plain
version agree bit for bit.

``splitk_wo_matmul`` is the weight-only form: float x (f32 or bf16) times
a split-K weight with a per-tensor, per-channel or grouped scale,
dequantize-then-dot, computed by ``csrc/qmatmul_wo.cu`` on CUDA tensors
and by ``splitk_wo_matmul_reference`` on CPU tensors. Its f32 sums run in
another order than the plain version's, so the two agree to rounding.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..intops import int_matmul, qrange
from .build import load
from .pack import unpack_bitplanes, unpack_splitk

_X_TYPES = {torch.int8: 0, torch.int32: 1, torch.float32: 2}
_MAX_GRID_Y = 65535
_BLOCK_M = 128  # rows of x per CUDA block (csrc/qmatmul.cu: BM)


class _QMMParams(ctypes.Structure):
    """Mirror of ``QMMParams`` in csrc/qmatmul.cu."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "M", "N", "K", "KR", "bits", "x_type", "quantize_x", "has_zp",
        "x_zp", "has_bias", "has_wvec", "out_int8", "has_res_zp",
        "x_vec", "w_vec")] + [(name, ctypes.c_float) for name in (
            "x_scale", "scale", "inv_res", "res_zp", "xq_lo", "xq_hi",
            "rq_lo", "rq_hi")]


def _constants(*, bit_width, x_scale, w_scale, out_requant) -> dict:
    """The f32 scalars of the epilogue, rounded as the JAX wrapper rounds
    them on the host (qmatmul.py:84, :465-472)."""
    f32 = np.float32
    xq_lo, xq_hi = qrange(bit_width)
    c = {"x_scale": f32(x_scale), "xq_lo": xq_lo, "xq_hi": xq_hi,
         "scale": None if w_scale is None else f32(f32(x_scale) * f32(w_scale)),
         "inv_res": f32(1.0), "res_zp": None, "rq_lo": -128.0, "rq_hi": 127.0}
    if out_requant is not None:
        res_scale, res_zp, res_bits = out_requant
        c["inv_res"] = f32(1.0 / f32(res_scale))
        c["res_zp"] = None if res_zp is None else f32(res_zp)
        c["rq_lo"], c["rq_hi"] = qrange(res_bits)
    return c


def _full(value, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``: torch divides by it exactly (a
    python-scalar divisor is a reciprocal multiply on CUDA)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _row(t, n: int, device, dtype) -> torch.Tensor:
    """A [1, N] operand (tensor or host array) as a contiguous tensor."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(t)))
    t = t.to(device=device, dtype=dtype).reshape(-1)
    if t.numel() != n:
        raise ValueError(f"expected {n} columns, got {t.numel()}")
    return t.contiguous()


def _quantize_x(x: torch.Tensor, c: dict, x_zp) -> torch.Tensor:
    """The kernel's activation quantize: IEEE divide, +zp, clip, rint."""
    q = x.to(torch.float32) / _full(c["x_scale"], x.device)
    if x_zp is not None:
        q = q + _full(x_zp, x.device)
    q = torch.clamp(q, c["xq_lo"], c["xq_hi"])
    return torch.round(q).to(torch.int8)


def _reference(x, w: torch.Tensor, colsum, bias, w_scale_vec, *, bit_width,
               x_scale, x_zp, w_scale, quantize_x, out_requant):
    """The shared plain version: ``w`` is the unpacked int8 [K, N]."""
    c = _constants(bit_width=bit_width, x_scale=x_scale, w_scale=w_scale,
                   out_requant=out_requant)
    dev = x.device
    n = w.shape[1]
    xq = _quantize_x(x, c, x_zp) if quantize_x else x.to(torch.int8)
    acc = int_matmul(xq, w)
    if x_zp is not None:
        acc = acc - _row(colsum, n, dev, torch.int32).reshape(1, n) \
            * torch.full((), int(x_zp), dtype=torch.int32, device=dev)
    if w_scale_vec is None:
        scale_row = _full(c["scale"], dev)
    else:
        scale_row = _full(c["x_scale"], dev) \
            * _row(w_scale_vec, n, dev, torch.float32).reshape(1, n)
    y = acc.to(torch.float32) * scale_row
    if bias is not None:
        y = y + _row(bias, n, dev, torch.float32).reshape(1, n)
    if out_requant is None:
        return y
    q = y * _full(c["inv_res"], dev)
    if c["res_zp"] is not None:
        q = q + _full(c["res_zp"], dev)
    return torch.clamp(torch.round(q), c["rq_lo"], c["rq_hi"]).to(torch.int8)


def splitk_qmatmul_reference(x, packed, colsum, bias=None, w_scale_vec=None,
                             *, bits: int, bit_width: int, x_scale: float,
                             x_zp: int | None, w_scale: float | None = None,
                             quantize_x: bool = True,
                             out_requant: tuple | None = None):
    """Plain PyTorch version of ``splitk_qmatmul``."""
    k = x.shape[1]
    w = packed.to(torch.int8) if bits == 8 else unpack_splitk(packed, bits, k)
    return _reference(x, w, colsum, bias, w_scale_vec, bit_width=bit_width,
                      x_scale=x_scale, x_zp=x_zp, w_scale=w_scale,
                      quantize_x=quantize_x, out_requant=out_requant)


def packed_qmatmul_reference(x, planes, colsum, bias=None, w_scale_vec=None,
                             *, bits: int, bit_width: int, x_scale: float,
                             x_zp: int | None, w_scale: float | None = None,
                             quantize_x: bool = True,
                             out_requant: tuple | None = None):
    """Plain PyTorch version of ``packed_qmatmul``."""
    w = unpack_bitplanes(planes, bits, x.shape[1])
    return _reference(x, w, colsum, bias, w_scale_vec, bit_width=bit_width,
                      x_scale=x_scale, x_zp=x_zp, w_scale=w_scale,
                      quantize_x=quantize_x, out_requant=out_requant)


def _check(x, payload, *, layout, bits, quantize_x, w_scale, w_scale_vec):
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError("x must be a 2-D tensor [M, K]")
    if payload.device != x.device:
        raise ValueError("x and the packed weight must lie on one device")
    if (w_scale is None) == (w_scale_vec is None):
        raise ValueError("pass exactly one of w_scale and w_scale_vec")
    if quantize_x and x.dtype != torch.float32:
        raise TypeError("quantize_x=True takes float32 x")
    if not quantize_x and x.dtype not in (torch.int8, torch.int32):
        raise TypeError("quantize_x=False takes int8 or int32 x")
    k = x.shape[1]
    if layout == "splitk":
        if bits not in (1, 2, 4, 8):
            raise ValueError(f"split-K packs 1/2/4/8 bits, not {bits}")
        want = torch.int8 if bits == 8 else torch.uint8
        if payload.dtype != want or payload.ndim != 2:
            raise TypeError(f"split-K payload at {bits} bits is a 2-D {want}")
        if payload.shape[0] * (8 // bits) < k:
            raise ValueError(f"payload {tuple(payload.shape)} holds fewer "
                             f"than K={k} rows")
    else:
        if not 1 <= bits <= 8:
            raise ValueError(f"bit-planes pack 1..8 bits, not {bits}")
        if payload.dtype != torch.uint8 or payload.ndim != 3 \
                or payload.shape[0] != bits:
            raise TypeError(f"bit-planes are uint8 [{bits}, K/8, N]")
        if payload.shape[1] * 8 < k:
            raise ValueError(f"planes {tuple(payload.shape)} hold fewer "
                             f"than K={k} rows")


def _launch(entry: str, x, payload, colsum, bias, w_scale_vec, *, bits, bit_width, x_scale, x_zp, w_scale, quantize_x,
            out_requant) -> torch.Tensor:
    dev = x.device
    m, k = x.shape
    n = payload.shape[-1]
    if -(-m // _BLOCK_M) > _MAX_GRID_Y:
        raise ValueError(f"M={m} rows exceed the kernel's grid")
    x = x.contiguous()
    payload = payload.contiguous()
    colsum = _row(colsum, n, dev, torch.int32)
    wvec = None if w_scale_vec is None \
        else _row(w_scale_vec, n, dev, torch.float32)
    bias = None if bias is None else _row(bias, n, dev, torch.float32)
    c = _constants(bit_width=bit_width, x_scale=x_scale, w_scale=w_scale,
                   out_requant=out_requant)
    out = torch.empty((m, n), device=dev, dtype=torch.float32
                      if out_requant is None else torch.int8)
    if out.numel() == 0:
        return out
    # rows that can be read a word (4 elements) at a time
    x_vec = k % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
    w_vec = n % 4 == 0 and payload.data_ptr() % 4 == 0
    p = _QMMParams(
        M=m, N=n, K=k, KR=payload.shape[-2], bits=bits,
        x_type=_X_TYPES[x.dtype], quantize_x=int(quantize_x),
        has_zp=int(x_zp is not None), x_zp=0 if x_zp is None else int(x_zp),
        has_bias=int(bias is not None), has_wvec=int(wvec is not None),
        out_int8=int(out_requant is not None),
        has_res_zp=int(c["res_zp"] is not None), x_vec=int(x_vec),
        w_vec=int(w_vec),
        x_scale=c["x_scale"], scale=0.0 if c["scale"] is None else c["scale"],
        inv_res=c["inv_res"],
        res_zp=0.0 if c["res_zp"] is None else c["res_zp"],
        xq_lo=c["xq_lo"], xq_hi=c["xq_hi"], rq_lo=c["rq_lo"],
        rq_hi=c["rq_hi"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_library(), entry)(
        x.data_ptr(), payload.data_ptr(), colsum.data_ptr(),
        None if wvec is None else wvec.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


def _dispatch(fn, reference, entry, layout, x, payload, colsum, bias,
              w_scale_vec, kw):
    _check(x, payload, layout=layout, bits=kw["bits"],
           quantize_x=kw["quantize_x"], w_scale=kw["w_scale"],
           w_scale_vec=w_scale_vec)
    if x.device.type == "cpu":
        return reference(x, payload, colsum, bias, w_scale_vec, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no {entry} kernel for device {x.device}")
    out = _launch(entry, x, payload, colsum, bias, w_scale_vec, **kw)
    fn.launches += 1
    return out


def splitk_qmatmul(x, packed, colsum, bias=None, w_scale_vec=None, *,
                   bits: int, bit_width: int, x_scale: float,
                   x_zp: int | None, w_scale: float | None = None,
                   quantize_x: bool = True,
                   out_requant: tuple | None = None):
    """y = dequant(quant(x) @ unpack_splitk(packed)) + bias.

    x [M, K]: float32 (``quantize_x=True``) or int8/int32 holding
    quantized values. packed: int8 [K, N] at 8 bits, uint8 [ceil(K/r), N]
    at 1/2/4 bits. colsum: int32 [1, N]. Weight scale: the scalar
    ``w_scale`` or the per-channel ``w_scale_vec`` [1, N]. bias: optional
    f32 [1, N]. ``out_requant=(res_scale, res_zp, res_bits)`` returns int8,
    else float32 [M, N]. CUDA tensors launch the kernel (or raise); CPU
    tensors take ``splitk_qmatmul_reference``."""
    kw = dict(bits=bits, bit_width=bit_width, x_scale=x_scale, x_zp=x_zp,
              w_scale=w_scale, quantize_x=quantize_x, out_requant=out_requant)
    return _dispatch(splitk_qmatmul, splitk_qmatmul_reference,
                     "nq_splitk_qmatmul", "splitk", x, packed, colsum, bias,
                     w_scale_vec, kw)


def packed_qmatmul(x, planes, colsum, bias=None, w_scale_vec=None, *,
                   bits: int, bit_width: int, x_scale: float,
                   x_zp: int | None, w_scale: float | None = None,
                   quantize_x: bool = True,
                   out_requant: tuple | None = None):
    """``splitk_qmatmul``'s function over bit-planes uint8 [b, ceil(K/8), N]
    (any width 1..8). CUDA tensors launch the kernel (or raise); CPU
    tensors take ``packed_qmatmul_reference``."""
    kw = dict(bits=bits, bit_width=bit_width, x_scale=x_scale, x_zp=x_zp,
              w_scale=w_scale, quantize_x=quantize_x, out_requant=out_requant)
    return _dispatch(packed_qmatmul, packed_qmatmul_reference,
                     "nq_packed_qmatmul", "bitplanes", x, planes, colsum,
                     bias, w_scale_vec, kw)


splitk_qmatmul.launches = 0
packed_qmatmul.launches = 0


# -- weight-only: float x times a split-K packed weight ----------------------

_WO_TYPES = (torch.float32, torch.bfloat16)
# csrc/qmatmul_wo.cu: output columns and rows of x per block, values of v
# per chunk, the largest cluster along K
WO_TILE_N, WO_TILE_M, WO_CHUNK, WO_MAX_CLUSTER = 32, 8, 16, 16
_WO_SCALE_SMEM = 32 * 1024  # a block stages its scale rows up to this size


class _WOParams(ctypes.Structure):
    """Mirror of ``WOParams`` in csrc/qmatmul_wo.cu."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "M", "N", "K", "KR", "bits", "x_bf16", "scale_rows", "gsz",
        "gsz_log2", "cluster", "rows_per_rank", "w_vec", "s_vec",
        "scale_smem", "fast", "x_vec")] \
        + [("scale", ctypes.c_float)]


def wo_plan(m: int, n: int, kr: int, bits: int, sms: int) -> dict:
    """The launch plan of ``splitk_wo_matmul``'s kernel for x [m, K] and a
    payload of ``kr`` packed rows by ``n`` columns on a card of ``sms``
    SMs: blocks of WO_TILE_N columns by WO_TILE_M rows of x, and the packed
    rows split along K across a cluster of ``cluster`` blocks (a power of
    two up to WO_MAX_CLUSTER), doubled while the grid has fewer blocks
    than SMs and every rank keeps at least one chunk; rank r takes packed
    rows [r * rows_per_rank, (r + 1) * rows_per_rank) of the payload."""
    rows_per_chunk = WO_CHUNK // (8 // bits)
    chunks = -(-kr // rows_per_chunk)
    tiles = -(-n // WO_TILE_N) * -(-m // WO_TILE_M)
    cluster = 1
    while (cluster < WO_MAX_CLUSTER and tiles * cluster < sms
           and 2 * cluster <= chunks):
        cluster *= 2
    rows_per_rank = -(-chunks // cluster) * rows_per_chunk
    return {"tile_n": WO_TILE_N, "tile_m": WO_TILE_M, "cluster": cluster,
            "rows_per_rank": rows_per_rank, "blocks": tiles * cluster}


def wo_groups_tile(k: int, kr: int, groups: int, bits: int) -> bool:
    """Whether ``groups`` scale rows over K tile the split-K bit fields of
    height ``kr`` evenly (within a field or across whole fields), which the
    JAX kernel requires of a grouped scale. True at 8 bits (no fields) and
    for a single row."""
    if bits == 8 or groups <= 1:
        return True
    gsz = k // groups
    return gsz > 0 and (kr % gsz == 0 or gsz % kr == 0)


def _wo_scale(scale, k: int, n: int, kr: int, bits: int, group_size,
              device):
    """(scalar, rows, gsz): a per-tensor scale as an f32 python float, or
    the scale rows as an f32 [G, N] tensor on ``device`` with G = 1 per
    channel (gsz = K) or G = K/gsz grouped. Raises, as the JAX wrapper
    does, for groups that tile the split-K bit fields neither way."""
    if isinstance(scale, torch.Tensor):
        s = scale.to(device=device, dtype=torch.float32)
        if s.numel() == 1:
            return float(s.reshape(())), None, k
    else:
        a = np.asarray(scale, np.float32)
        if a.size == 1:  # a host scalar stays on the host
            return float(a.reshape(())), None, k
        s = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if s.ndim < 2 or s.shape[0] == 1:
        if s.numel() != n:
            raise ValueError(f"expected {n} channel scales, got {s.numel()}")
        return None, s.reshape(1, n).contiguous(), k
    g = int(s.shape[0])
    gsz = k // g
    if g * gsz != k or s.shape[1] != n:
        raise ValueError(f"grouped scale {tuple(s.shape)} does not tile "
                         f"[K={k}, N={n}]")
    if group_size is not None and int(group_size) != gsz:
        raise ValueError(f"group_size {group_size} != K/groups {gsz}")
    if not wo_groups_tile(k, kr, g, bits):
        raise ValueError(f"group_size {gsz} must divide or be a multiple "
                         f"of the split-K field height {kr}")
    return None, s.contiguous(), gsz


def _wo_check(x, packed, bits: int):
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError("x must be a 2-D tensor [M, K]")
    if x.dtype not in _WO_TYPES:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if packed.device != x.device:
        raise ValueError("x and the packed weight must lie on one device")
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"split-K packs 1/2/4/8 bits, not {bits}")
    want = torch.int8 if bits == 8 else torch.uint8
    if packed.dtype != want or packed.ndim != 2:
        raise TypeError(f"split-K payload at {bits} bits is a 2-D {want}")
    if packed.shape[0] * (8 // bits) < x.shape[1]:
        raise ValueError(f"payload {tuple(packed.shape)} holds fewer than "
                         f"K={x.shape[1]} rows")


def splitk_wo_matmul_reference(x, packed, scale, *, bits: int,
                               group_size: int | None = None):
    """Plain PyTorch version of ``splitk_wo_matmul``: the weight unpacked
    and dequantized whole (one f32 product per element, rounded once to
    x's type), then an f32 product of the upcast operands, cast once."""
    k = x.shape[1]
    n = packed.shape[1]
    scalar, rows, gsz = _wo_scale(scale, k, n, packed.shape[0], bits,
                                  group_size, x.device)
    w = packed.to(torch.int8)[:k] if bits == 8 \
        else unpack_splitk(packed, bits, k)
    if scalar is not None:
        s = torch.full((), scalar, dtype=torch.float32, device=x.device)
    else:
        s = rows if rows.shape[0] == 1 else \
            torch.repeat_interleave(rows, gsz, dim=0)
    wf = (w.to(torch.float32) * s).to(x.dtype)
    y = torch.matmul(x.to(torch.float32), wf.to(torch.float32))
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _wo_launch(x, packed, scalar, rows, gsz, bits: int) -> torch.Tensor:
    dev = x.device
    m, k = x.shape
    kr, n = packed.shape
    out = torch.empty((m, n), device=dev, dtype=x.dtype)
    if out.numel() == 0:
        return out
    if -(-m // WO_TILE_M) > _MAX_GRID_Y:
        raise ValueError(f"M={m} rows exceed the kernel's grid")
    plan = wo_plan(m, n, kr, bits, _sm_count(dev.index or 0))
    x = x.contiguous()
    packed = packed.contiguous()
    scale_rows = 0 if rows is None else rows.shape[0]
    # a single scale row is group 0 for every v (v >> 30 == 0)
    gsz_log2 = 30 if scale_rows == 1 else \
        gsz.bit_length() - 1 if gsz & (gsz - 1) == 0 else -1
    w_vec = n % 4 == 0 and packed.data_ptr() % 4 == 0
    s_vec = scale_rows > 0 and n % 4 == 0 and rows.data_ptr() % 16 == 0
    # the kernel's form for bf16 x whose loads are all 4-byte payload words
    # and float4 scale rows, one group per field in each chunk of
    # WO_CHUNK values (WO_CHUNK / (8 / bits) packed rows)
    fast = x.dtype == torch.bfloat16 and w_vec and s_vec and gsz_log2 >= 0 \
        and (scale_rows == 1 or gsz % (WO_CHUNK * bits // 8) == 0)
    # the other form stages a block's scale rows in shared memory
    scale_smem = not fast and 0 < scale_rows * WO_TILE_N * 4 <= _WO_SCALE_SMEM
    # bf16 x staged with 16-byte loads: every run of x it reads is aligned
    x_vec = k % 8 == 0 and kr % 8 == 0 and plan["rows_per_rank"] % 8 == 0 \
        and x.data_ptr() % 16 == 0
    p = _WOParams(
        M=m, N=n, K=k, KR=kr, bits=bits, x_bf16=int(x.dtype == torch.bfloat16),
        scale_rows=scale_rows, gsz=gsz, gsz_log2=gsz_log2,
        cluster=plan["cluster"], rows_per_rank=plan["rows_per_rank"],
        w_vec=int(w_vec), s_vec=int(s_vec), scale_smem=int(scale_smem),
        fast=int(fast), x_vec=int(x_vec),
        scale=0.0 if scalar is None else scalar)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _wo_library().nq_splitk_wo_matmul(
        x.data_ptr(), packed.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(),
        ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"nq_splitk_wo_matmul kernel launch failed: "
                           f"CUDA error {rc}")
    return out


def splitk_wo_matmul(x, packed, scale, *, bits: int,
                     group_size: int | None = None):
    """y = x @ (unpack_splitk(packed) * expand(scale)), weight-only: float
    compute, the dequantize fused into the weight load.

    x [M, K] float32 or bfloat16; packed uint8 [ceil(K/r), N] split-K
    payload (int8 [K, N] at 8 bits); scale a scalar (per tensor), [1, N] or
    [N] (per output channel) or [K/g, N] (grouped), as a tensor or host
    array. Returns [M, N] in x's dtype. CUDA tensors launch the kernel of
    csrc/qmatmul_wo.cu (or raise); CPU tensors take
    ``splitk_wo_matmul_reference``."""
    _wo_check(x, packed, bits)
    if x.device.type == "cpu":
        return splitk_wo_matmul_reference(x, packed, scale, bits=bits,
                                          group_size=group_size)
    if x.device.type != "cuda":
        raise ValueError(f"no splitk_wo_matmul kernel for device {x.device}")
    scalar, rows, gsz = _wo_scale(scale, x.shape[1], packed.shape[1],
                                  packed.shape[0], bits, group_size, x.device)
    out = _wo_launch(x, packed, scalar, rows, gsz, bits)
    splitk_wo_matmul.launches += 1
    return out


splitk_wo_matmul.launches = 0


def _library() -> ctypes.CDLL:
    lib = load("qmatmul")
    if not getattr(lib, "_nq_typed", False):
        for name in ("nq_splitk_qmatmul", "nq_packed_qmatmul"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(_QMMParams),
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._nq_typed = True
    return lib


def _wo_library() -> ctypes.CDLL:
    lib = load("qmatmul_wo")
    if not getattr(lib, "_nq_typed", False):
        fn = lib.nq_splitk_wo_matmul
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(_WOParams),
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._nq_typed = True
    return lib
