"""Elementwise quantize and dequantize.

Port of ``numpy_quant_tpu/kernels/elementwise.py::quantize_pallas`` and
``::dequantize_pallas``. The JAX executor never calls those kernels; in
the port these are the executor's quantize boundaries:
``quantization.quantize`` (float -> integer container) and
``quantization.dequantize`` (integer -> float, also requantize's first
step) call ``quantize`` and ``dequantize`` here, and every call on a CUDA
tensor launches ``csrc/elementwise.cu``.

    quantize:   y = cast(rint(clamp(zp + x / scale, lo, hi)))
    dequantize: y = float(x - zp) * scale

Forms: x float32 or bfloat16 (quantize), int8, int32 or int64
(dequantize); the scale a scalar or a float32 tensor broadcast against x
(per-channel rows); the zero point none, a scalar or an integer tensor
broadcast against x (a matmul accumulator's row, column or full
corrections). The numerics follow the container: int8/int32 quantize and
int8/int32 dequantize run the JAX package's TPU mode (f32 arithmetic,
int32 subtract); int64 is its x64 mode (the zero point added in f64, the
dequantize product taken in f64 and rounded once to f32). A zero scale
anywhere makes 0/0 quantize to 0, as XLA's conversion does.

Each wrapper checks its arguments and calls its custom op
(``nqt::quantize``, ``nqt::dequantize``; ``torch.export`` traces them
through their fake versions). The dispatcher sends CPU tensors to the
plain versions ``*_reference`` (the torch chains) and CUDA tensors to the
kernels, which equal the plain versions bit for bit, or raise; any other
device raises. Each wrapper's ``launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..intops import as_tensor, qrange
from .build import load

MAX_DIMS = 6  # csrc/elementwise.cu: NQ_MAX_DIMS
_Q_IN = {torch.float32: 0, torch.bfloat16: 1}
_Q_OUT = {torch.int8: 0, torch.int32: 1, torch.int64: 2}
_D_IN = {torch.int8: 0, torch.int32: 1, torch.int64: 2}
_D_OUT = {torch.float32: 0, torch.bfloat16: 1}


class _Bcast(ctypes.Structure):
    """Mirror of ``Bcast`` in csrc/elementwise.cu."""
    _fields_ = [("ndim", ctypes.c_int), ("size", ctypes.c_int * MAX_DIMS),
                ("stride", ctypes.c_longlong * MAX_DIMS)]


class _EWParams(ctypes.Structure):
    """Mirror of ``EWParams`` in csrc/elementwise.cu."""
    _fields_ = ([("n", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in (
                    "in_type", "out_type", "zp_mode", "zp_int64",
                    "scale_vec", "nan_to_zero", "vec")]
                + [(name, ctypes.c_float) for name in (
                    "scale", "lo_f", "hi_f")]
                + [("zp", ctypes.c_longlong), ("lo", ctypes.c_double),
                   ("hi", ctypes.c_double), ("scale_d", ctypes.c_double),
                   ("sb", _Bcast), ("zb", _Bcast)])


def _any_zero(scale) -> bool:
    """Whether a host scale holds a zero. A tensor scale counts as one:
    its values are not read back (a device read would sync the host), and
    mapping a NaN to 0 changes no result there -- the card's conversion
    to an integer already maps NaN to 0, as XLA's does."""
    if isinstance(scale, torch.Tensor):
        return True
    return bool(np.any(np.asarray(scale) == 0))


# -- the plain versions: the executor's torch chains ------------------------

def quantize_reference(x: torch.Tensor, bit_width: int, scale, zero_point,
                       out_dtype=torch.int32) -> torch.Tensor:
    """Plain PyTorch version of ``quantize``: divide, +zp, clip, rint."""
    return _quantize_plain(x, bit_width, scale, zero_point, out_dtype,
                           _any_zero(scale))


def _quantize_plain(x, bit_width, scale, zero_point, out_dtype,
                    nan_to_zero: bool) -> torch.Tensor:
    wide = out_dtype == torch.int64
    q = x.to(torch.float32) / as_tensor(scale, x.device)
    if zero_point is not None:
        if wide:
            # numpy promotes int64 + float32 to float64 (x64 mode)
            q = as_tensor(zero_point, x.device, torch.float64) \
                + q.to(torch.float64)
        else:
            q = as_tensor(zero_point, x.device) + q
    if nan_to_zero:
        # a constant-valued tensor's zero scale gives 0/0: XLA's
        # float->int conversion maps that NaN to 0, torch's does not
        q = torch.nan_to_num(q, nan=0.0)
    min_qval, max_qval = qrange(bit_width)
    q = torch.clamp(q, min_qval, max_qval)
    return torch.round(q).to(out_dtype)


def dequantize_reference(q: torch.Tensor, scale, zero_point,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of ``dequantize``."""
    if q.dtype != torch.int32 and q.dtype != torch.int64:
        # narrow int8 storage widens before the zero-point subtract
        q = q.to(torch.int32)
    if zero_point is not None:
        q = q - as_tensor(zero_point, q.device, q.dtype)
    if q.dtype == torch.int64:
        # x64 mode: one f64 product rounded to f32, not two roundings
        y = (q.to(torch.float64)
             * as_tensor(scale, q.device, torch.float64)).to(torch.float32)
    else:
        y = q.to(torch.float32) * as_tensor(scale, q.device)
    return y if out_dtype == torch.float32 else y.to(out_dtype)


# -- the kernels --------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def _row_major(shape: tuple) -> tuple:
    return tuple(d for d in range(len(shape)) if shape[d] != 1)


def _memory_order(t: torch.Tensor):
    """The dims of a dense non-overlapping ``t`` (size-1 dims left out),
    outermost first in memory; None if it is not dense."""
    if t.is_contiguous():
        return _row_major(tuple(t.shape))
    dims = sorted((d for d in range(t.ndim) if t.shape[d] != 1),
                  key=lambda d: -t.stride(d))
    expect = 1
    for d in reversed(dims):
        if t.stride(d) != expect:
            return None
        expect *= t.shape[d]
    return tuple(dims)


def _walk(op: torch.Tensor, shape, dims) -> _Bcast:
    """The offsets of ``op`` broadcast to ``shape``, as (size, stride) dims
    in the memory order ``dims`` of the data, merged where they run on
    contiguously."""
    return _walk_of(tuple(op.shape), op.stride(), tuple(shape), dims)


@functools.lru_cache(maxsize=4096)
def _walk_of(osize: tuple, ostride: tuple, shape: tuple,
             dims: tuple) -> _Bcast:
    lead = len(shape) - len(osize)
    if lead < 0 or any(osize[i] not in (1, shape[lead + i])
                       for i in range(len(osize))):
        raise ValueError(f"operand {tuple(osize)} does not broadcast to "
                         f"{tuple(shape)} without growing it")
    merged = []
    for d in dims:
        size = shape[d]
        stride = 0 if d < lead or osize[d - lead] == 1 \
            else ostride[d - lead]
        if merged and merged[-1][1] == stride * size:
            merged[-1] = (merged[-1][0] * size, stride)
        else:
            merged.append((size, stride))
    if len(merged) > MAX_DIMS:
        raise ValueError(f"operand walk needs {len(merged)} dims "
                         f"(at most {MAX_DIMS})")
    b = _Bcast()
    b.ndim = len(merged)
    for i, (size, stride) in enumerate(merged):
        b.size[i] = size
        b.stride[i] = stride
    return b


_SCALARS = (float, int, np.floating, np.integer)


def _is_scalar(v) -> bool:
    return isinstance(v, _SCALARS) or (
        not isinstance(v, torch.Tensor) and np.ndim(v) == 0)


def _operands(x: torch.Tensor, scale, zero_point):
    """(x made dense, params, scale tensor, zero-point tensor): the scale
    by value (in f32, and in f64 for the int64 dequantize, which the chain
    multiplies by a float64 tensor of it) or as an f32 tensor, the zero
    point none, by value or as an int32/int64 tensor, each tensor's walk
    in x's memory order. Sets ``nan_to_zero`` where a scale may be 0
    (``_any_zero``)."""
    dims = None
    if not x.is_contiguous():
        dims = _memory_order(x)
        if dims is None:
            # a dense copy with x's dim order, as torch's elementwise ops
            # allocate their outputs
            x = torch.empty_like(x).copy_(x)
            dims = _memory_order(x)
    p = _EWParams()
    svec = zvec = None
    if _is_scalar(scale):
        p.scale_d = float(scale)
        p.scale = float(np.float32(scale))
        p.nan_to_zero = p.scale_d == 0.0
    else:
        if dims is None:
            dims = _memory_order(x)
        svec = as_tensor(scale, x.device)
        p.scale_vec = 1
        p.sb = _walk(svec, x.shape, dims)
        p.nan_to_zero = _any_zero(scale)
    if zero_point is None:
        p.zp_mode = 0
    elif not _is_scalar(zero_point):
        if dims is None:
            dims = _memory_order(x)
        zvec = zero_point if isinstance(zero_point, torch.Tensor) \
            else as_tensor(zero_point, x.device, torch.int64)
        if zvec.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"zero-point tensors are int32 or int64, "
                            f"not {zvec.dtype}")
        zvec = zvec.to(x.device)
        p.zp_mode = 2
        p.zp_int64 = int(zvec.dtype == torch.int64)
        p.zb = _walk(zvec, x.shape, dims)
    else:
        p.zp_mode = 1
        p.zp = int(zero_point)
    return x, p, svec, zvec


@functools.lru_cache(maxsize=None)
def _bounds(bit_width: int) -> tuple:
    """The clip bounds in f64 and rounded to f32, as torch.clamp takes
    them for an f64 or an f32 tensor."""
    lo, hi = qrange(bit_width)
    return lo, hi, float(np.float32(lo)), float(np.float32(hi))


def _launch(entry: str, x, out, p, svec, zvec) -> None:
    p.n = x.numel()
    if p.n >= 2 ** 31:
        raise ValueError(f"{p.n} elements exceed the kernel's 32-bit index")
    p.vec = int(x.data_ptr() % (4 * x.element_size()) == 0
                and out.data_ptr() % (4 * out.element_size()) == 0)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    rc = getattr(_library(), entry)(
        x.data_ptr(), out.data_ptr(),
        None if svec is None else svec.data_ptr(),
        None if zvec is None else zvec.data_ptr(), ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")


def quantize(x: torch.Tensor, bit_width: int, scale, zero_point=None,
             out_dtype=torch.int32) -> torch.Tensor:
    """x (float32 or bfloat16) -> ``out_dtype`` (int8, int32 or int64)
    quantized values at ``bit_width`` bits: rint(clip(x / scale + zp)).
    int64 out adds the zero point in f64 (x64 mode). The result has x's
    shape and, where x is dense, its strides. Runs the custom op
    ``nqt::quantize``: CUDA tensors launch the kernel of
    csrc/elementwise.cu (or raise); CPU tensors take
    ``quantize_reference``."""
    if x.dtype not in _Q_IN:
        raise TypeError(f"quantize takes float32 or bfloat16, not {x.dtype}")
    if out_dtype not in _Q_OUT:
        raise TypeError(f"quantize writes int8, int32 or int64, "
                        f"not {out_dtype}")
    if not 1 <= bit_width <= (8 if out_dtype == torch.int8 else 64):
        raise ValueError(f"{bit_width} bits do not fit {out_dtype}")
    if x.device.type not in _DEVICES:
        raise ValueError(f"no quantize kernel for device {x.device}")
    return torch.ops.nqt.quantize(x, bit_width, *_op_args(x, scale,
                                                         zero_point),
                                  out_dtype)


def dequantize(q: torch.Tensor, scale, zero_point=None,
               out_dtype=torch.float32) -> torch.Tensor:
    """q (int8, int32 or int64) -> ``out_dtype`` (float32 or bfloat16):
    float(q - zp) * scale, in f32 for int8/int32 and as one f64 product
    rounded to f32 for int64 (x64 mode). The result has q's shape and,
    where q is dense, its strides. Runs the custom op
    ``nqt::dequantize``: CUDA tensors launch the kernel of
    csrc/elementwise.cu (or raise); CPU tensors take
    ``dequantize_reference``."""
    if q.dtype not in _D_IN:
        raise TypeError(f"dequantize takes int8, int32 or int64, "
                        f"not {q.dtype}")
    if out_dtype not in _D_OUT:
        raise TypeError(f"dequantize writes float32 or bfloat16, "
                        f"not {out_dtype}")
    if q.device.type not in _DEVICES:
        raise ValueError(f"no dequantize kernel for device {q.device}")
    scale, scale_t, zp, zp_t, _ = _op_args(q, scale, zero_point)
    return torch.ops.nqt.dequantize(q, scale, scale_t, zp, zp_t, out_dtype)


quantize.launches = 0
dequantize.launches = 0


# -- the custom ops -------------------------------------------------------
#
# nqt::quantize and nqt::dequantize take the scale and the zero point each
# as a value (a float) or a tensor: a host array is placed on the device
# before the op (intops.place, once per distinct array), so the schema
# holds no host object. ``nan_to_zero`` is _any_zero of the caller's scale,
# read on the host where it lies there.

_DEVICES = ("cpu", "cuda")


def _op_args(x: torch.Tensor, scale, zero_point) -> tuple:
    """(scale, scale tensor, zero point, zero-point tensor, nan_to_zero) as
    the ops take them, on x's device."""
    if _is_scalar(scale):
        scale, scale_t = float(scale), None
        nan_to_zero = scale == 0.0
    else:
        nan_to_zero = _any_zero(scale)
        scale_t = scale.to(x.device) if isinstance(scale, torch.Tensor) \
            else as_tensor(scale, x.device)
        scale = 0.0
    zp_t = None
    if zero_point is not None and not _is_scalar(zero_point):
        zp_t = zero_point.to(x.device) if isinstance(zero_point, torch.Tensor) \
            else as_tensor(zero_point, x.device, torch.int64)
        zero_point = None
    elif zero_point is not None:
        zero_point = float(zero_point)
    return scale, scale_t, zero_point, zp_t, nan_to_zero


def _pick(value, tensor):
    return value if tensor is None else tensor


@torch.library.custom_op("nqt::quantize", mutates_args=(),
                         device_types="cuda")
def _quantize_op(x: torch.Tensor, bit_width: int, scale: float,
                 scale_t: Optional[torch.Tensor], zero_point: Optional[float],
                 zp_t: Optional[torch.Tensor], nan_to_zero: bool,
                 out_dtype: torch.dtype) -> torch.Tensor:
    x, p, svec, zvec = _operands(x, _pick(scale, scale_t),
                                 _pick(zero_point, zp_t))
    p.nan_to_zero = int(nan_to_zero)
    out = torch.empty_like(x, dtype=out_dtype)
    if x.numel() == 0:
        return out
    p.in_type, p.out_type = _Q_IN[x.dtype], _Q_OUT[out_dtype]
    p.lo, p.hi, p.lo_f, p.hi_f = _bounds(bit_width)
    _launch("nq_quantize", x, out, p, svec, zvec)
    quantize.launches += 1
    return out


@_quantize_op.register_kernel("cpu")
def _quantize_cpu(x, bit_width, scale, scale_t, zero_point, zp_t,
                  nan_to_zero, out_dtype):
    y = _quantize_plain(x, bit_width, _pick(scale, scale_t),
                        _pick(zero_point, zp_t), out_dtype, nan_to_zero)
    return torch.empty_like(x, dtype=out_dtype).copy_(y)


@_quantize_op.register_fake
def _quantize_fake(x, bit_width, scale, scale_t, zero_point, zp_t,
                   nan_to_zero, out_dtype):
    return torch.empty_like(x, dtype=out_dtype)


@torch.library.custom_op("nqt::dequantize", mutates_args=(),
                         device_types="cuda")
def _dequantize_op(q: torch.Tensor, scale: float,
                   scale_t: Optional[torch.Tensor],
                   zero_point: Optional[float], zp_t: Optional[torch.Tensor],
                   out_dtype: torch.dtype) -> torch.Tensor:
    q, p, svec, zvec = _operands(q, _pick(scale, scale_t),
                                 _pick(zero_point, zp_t))
    out = torch.empty_like(q, dtype=out_dtype)
    if q.numel() == 0:
        return out
    p.in_type, p.out_type = _D_IN[q.dtype], _D_OUT[out_dtype]
    _launch("nq_dequantize", q, out, p, svec, zvec)
    dequantize.launches += 1
    return out


@_dequantize_op.register_kernel("cpu")
def _dequantize_cpu(q, scale, scale_t, zero_point, zp_t, out_dtype):
    y = dequantize_reference(q, _pick(scale, scale_t),
                             _pick(zero_point, zp_t), out_dtype)
    return torch.empty_like(q, dtype=out_dtype).copy_(y)


@_dequantize_op.register_fake
def _dequantize_fake(q, scale, scale_t, zero_point, zp_t, out_dtype):
    return torch.empty_like(q, dtype=out_dtype)


def _library() -> ctypes.CDLL:
    lib = load("elementwise")
    if not getattr(lib, "_nq_typed", False):
        for name in ("nq_quantize", "nq_dequantize"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(_EWParams),
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._nq_typed = True
    return lib
