"""Elementwise quantize, dequantize and fake quantize.

Port of ``numpy_quant_tpu/kernels/elementwise.py::quantize_pallas`` and
``::dequantize_pallas``. The JAX executor never calls those kernels; in
the port these are the executor's quantize boundaries:
``quantization.quantize`` (float -> integer container) and
``quantization.dequantize`` (integer -> float, also requantize's first
step) call ``quantize`` and ``dequantize`` here, ``fake_quantize`` is
their composition in one pass (DecodeAttention's fake quantization, which
XLA fuses into one loop in JAX's), and every call on a CUDA tensor
launches ``csrc/elementwise.cu``.

    quantize:      y = cast(rint(clamp(zp + x / scale, lo, hi)))
    dequantize:    y = float(x - zp) * scale
    fake_quantize: y = dequantize(quantize(x))

Forms: x float32 or bfloat16 (quantize, fake_quantize), int8, int32 or
int64 (dequantize); the scale a scalar or a float32 tensor broadcast
against x (per-channel rows); the zero point none, a scalar or an integer
tensor broadcast against x (a matmul accumulator's row, column or full
corrections). The numerics follow the container: int8/int32 quantize and
int8/int32 dequantize run the JAX package's TPU mode (f32 arithmetic,
int32 subtract); int64 is its x64 mode (the zero point added in f64, the
dequantize product taken in f64 and rounded once to f32). A zero scale
anywhere makes 0/0 quantize to 0, as XLA's conversion does.

A CUDA call runs a plan made once per call signature (shapes, strides,
dtypes: ``plan``): x as rows x columns in its memory order, x dense or
dense rows with a row stride (read in place; anything else is copied
dense first), and each broadcast operand as one of five forms against it
-- scalar, inner (varies only along the columns), outer (constant along
them), full (x's own walk) or general -- read at a row offset plus the
column times a column stride.

Each wrapper checks its arguments and calls its custom op
(``nqt::quantize``, ``nqt::dequantize``, ``nqt::fake_quantize``;
``torch.export`` traces them through their fake versions). The dispatcher
sends CPU tensors to the plain versions ``*_reference`` (the torch chains)
and CUDA tensors to the kernels, which equal the plain versions bit for
bit, or raise; any other device raises. Each wrapper's ``launches``
counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
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


def fake_quantize_reference(x: torch.Tensor, bit_width: int, scale,
                            zero_point, container=torch.int8) -> torch.Tensor:
    """Plain PyTorch version of ``fake_quantize``: the two plain versions
    in turn, through a ``container`` tensor."""
    return dequantize_reference(
        quantize_reference(x, bit_width, scale, zero_point, container),
        scale, zero_point)


# -- the plan ------------------------------------------------------------

NQ_THREADS = 256  # csrc/elementwise.cu: kThreads
_LONG_ROW = 1 << 16  # a dense run at least this long is cut into rows
_ROW_WIDTHS = (4096, 2048, 1024, 512)
# a launch with scalar operands whose wide vectors take fewer threads than
# this (about one resident wave of an H100: 132 SMs x 1,024) takes narrow
# ones, 16 bytes of the wider side
_NARROW_BELOW = 1 << 17
_OPS = {"quantize": 0, "dequantize": 1, "fake_quantize": 2}


class _Operand(ctypes.Structure):
    """Mirror of ``Operand`` in csrc/elementwise.cu."""
    _fields_ = [("rdims", ctypes.c_int), ("inner", ctypes.c_int),
                ("col_stride", ctypes.c_longlong),
                ("rstride", ctypes.c_longlong * MAX_DIMS),
                ("rsize", ctypes.c_uint * MAX_DIMS),
                ("magic", ctypes.c_ulonglong * MAX_DIMS),
                ("shift", ctypes.c_int * MAX_DIMS)]


class _EWPlan(ctypes.Structure):
    """Mirror of ``EWPlan`` in csrc/elementwise.cu."""
    _fields_ = ([(name, ctypes.c_longlong) for name in (
                    "rows", "cols", "x_rs")]
                + [(name, ctypes.c_int) for name in (
                    "op", "in_type", "out_type", "scale_vec", "zp_mode",
                    "zp_int64", "nan_to_zero", "bx", "by", "narrow")]
                + [("lo_f", ctypes.c_float), ("hi_f", ctypes.c_float),
                   ("lo", ctypes.c_double), ("hi", ctypes.c_double),
                   ("sb", _Operand), ("zb", _Operand)])


@dataclass(frozen=True)
class OperandWalk:
    """A broadcast operand read at ``row_offset(r) + c * col_stride``:
    ``rows`` the (size, stride) digits of the row index, innermost first
    (empty: every row offset is 0), each but the outermost divided off by
    its (magic, shift) multiply-shift; ``form`` inner, outer, full or
    general."""
    form: str
    col_stride: int
    rows: tuple
    magic: tuple


@dataclass(frozen=True)
class Plan:
    """x as ``rows`` x ``cols`` in its memory order, row r at
    ``r * x_rs`` (the output's row stride is ``cols``); ``copy``: x is
    neither dense nor dense rows and is made dense first (then plan the
    copy). ``vec`` elements make a thread's access (16 bytes on the
    narrow side or 32 on the wide one, whichever is more, at most 32
    bytes of stores; with ``narrow``, 16 bytes of the wide side); blocks
    are ``bx`` x ``by`` threads. ``scale``/``zp``: the operands' walks,
    None for a scalar or no zero point."""
    copy: bool
    rows: int = 0
    cols: int = 0
    x_rs: int = 0
    vec: int = 0
    bx: int = 0
    by: int = 0
    scale: Optional[OperandWalk] = None
    zp: Optional[OperandWalk] = None
    narrow: bool = False


def magic_div(d: int) -> tuple:
    """(magic, shift) with r // d == (r * magic) >> shift for every
    0 <= r < 2^31: l = ceil(log2 d), magic = ceil(2^(32 + l) / d), whose
    error magic * d - 2^(32 + l) < d <= 2^l keeps r * error below
    2^(32 + l); r * magic stays below 2^64."""
    l = (d - 1).bit_length()
    return -(-(1 << (32 + l)) // d), 32 + l


def _x_layout(shape: tuple, strides: tuple):
    """(dims in memory order, outermost first, size-1 dims left out;
    elements of the dense run that ends at stride 1; the row stride, None
    where x is dense) of x, or None where x is neither dense nor dense
    rows of one row stride."""
    dims = sorted((d for d in range(len(shape)) if shape[d] != 1),
                  key=lambda d: -strides[d])
    run, i = 1, len(dims)
    while i > 0 and strides[dims[i - 1]] == run:
        run *= shape[dims[i - 1]]
        i -= 1
    if dims and i == len(dims):
        return None
    if i == 0:
        return tuple(dims), run, None
    row_stride = expect = strides[dims[i - 1]]
    if row_stride < run:
        return None
    for d in reversed(dims[:i]):
        if strides[d] != expect:
            return None
        expect *= shape[d]
    return tuple(dims), run, row_stride


def _bcast_strides(osize: tuple, ostride: tuple, shape: tuple) -> tuple:
    """An operand's element strides along each dim of ``shape`` (0 where
    it broadcasts)."""
    lead = len(shape) - len(osize)
    if lead < 0 or any(osize[i] not in (1, shape[lead + i])
                       for i in range(len(osize))):
        raise ValueError(f"operand {tuple(osize)} does not broadcast to "
                         f"{tuple(shape)} without growing it")
    return tuple(0 if d < lead or osize[d - lead] == 1
                 else ostride[d - lead] for d in range(len(shape)))


def _block(cols: int, vec: int) -> tuple:
    """(bx, by): threads along the columns, a power of two that wastes
    the fewest vectors of a row (the widest of equals), the rest of the
    256 along rows."""
    vc = -(-cols // vec)
    if vc < NQ_THREADS:
        bx = 1 << (vc - 1).bit_length()
    else:
        bx = min((NQ_THREADS, 128, 64, 32),
                 key=lambda b: -(-vc // b) * b - vc)
    return bx, NQ_THREADS // bx


def _operand_walk(entries: list, k: int, rows: int, cols: int):
    """The walk of operand ``k`` over the merged (size, x stride, operand
    strides...) entries, the last of them the columns."""
    col_stride = entries[-1][2 + k]
    merged = []
    for e in entries[:-1]:
        size, stride = e[0], e[2 + k]
        if merged and merged[-1][1] == stride * size:
            merged[-1] = (merged[-1][0] * size, stride)
        else:
            merged.append((size, stride))
    while merged and merged[0][1] == 0:   # outermost digits read nothing
        merged.pop(0)
    if len(merged) > MAX_DIMS:
        raise ValueError(f"operand walk needs {len(merged)} row dims "
                         f"(at most {MAX_DIMS})")
    walk = tuple(reversed(merged))        # innermost first
    if not walk:
        form = "full" if rows == 1 and col_stride == 1 else "inner"
    elif col_stride == 0:
        form = "outer"
    elif walk == ((rows, cols),) and col_stride == 1:
        form = "full"
    else:
        form = "general"
    magic = tuple(magic_div(size) for size, _ in walk[:-1])
    return OperandWalk(form, col_stride, walk, magic)


@functools.lru_cache(maxsize=4096)
def plan(shape: tuple, strides: tuple, in_size: int, out_size: int,
         scale: Optional[tuple] = None, zp: Optional[tuple] = None) -> Plan:
    """The launch of one call signature: x's ``shape`` and ``strides``,
    the element sizes of x and y, and each tensor operand's (shape,
    strides) (None: a scalar or no zero point)."""
    layout = _x_layout(shape, strides)
    if layout is None:
        return Plan(copy=True)
    dims, run, row_stride = layout
    ops = [o for o in (scale, zp) if o is not None]
    ostr = [_bcast_strides(o[0], o[1], shape) for o in ops]
    entries = []
    for d in dims:
        e = (shape[d], strides[d]) + tuple(o[d] for o in ostr)
        if entries and all(entries[-1][j] == e[j] * e[0]
                           for j in range(1, len(e))):
            entries[-1] = (entries[-1][0] * e[0],) + e[1:]
        else:
            entries.append(e)
    if not entries:                       # a single element
        entries = [(1, 1) + (0,) * len(ops)]
    if row_stride is None and entries[-1][0] >= _LONG_ROW:
        # a long dense run becomes rows of a width that divides it: the
        # grid's blocks then own column segments and walk rows
        size, steps = entries[-1][0], entries[-1][1:]
        width = next((w for w in _ROW_WIDTHS if size % w == 0), None)
        if width is not None:
            entries[-1:] = [(size // width,) + tuple(t * width
                                                     for t in steps),
                            (width,) + steps]
    cols = entries[-1][0]
    if row_stride is not None and cols != run:
        # an operand splits the dense run of a row-strided x
        return Plan(copy=True)
    rows = int(np.prod([e[0] for e in entries[:-1]], dtype=np.int64))
    vec = min(max(16 // min(in_size, out_size),
                  32 // max(in_size, out_size)), 32 // out_size)
    narrow = not ops and -(-rows * cols // vec) < _NARROW_BELOW
    if narrow:
        vec = 16 // max(in_size, out_size)
    bx, by = _block(cols, vec)
    walks = [_operand_walk(entries, k, rows, cols) for k in range(len(ops))]
    it = iter(walks)
    return Plan(False, rows, cols, row_stride or cols, vec,
                bx, by, next(it) if scale is not None else None,
                next(it) if zp is not None else None, narrow)


def _fill(o: _Operand, walk: OperandWalk) -> None:
    o.inner = int(not walk.rows)
    o.col_stride = walk.col_stride
    o.rdims = len(walk.rows)
    for i, (size, stride) in enumerate(walk.rows):
        o.rsize[i] = size
        o.rstride[i] = stride
    for i, (magic, shift) in enumerate(walk.magic):
        o.magic[i] = magic
        o.shift[i] = shift


@functools.lru_cache(maxsize=4096)
def _plan_struct(pl: Plan, op: int, in_type: int, out_type: int,
                 bit_width: int, zp_mode: int, zp_int64: bool,
                 nan_to_zero: bool) -> _EWPlan:
    """The kernel's ``EWPlan`` of a call signature, made once: a call
    passes only its pointers and its scale and zero-point values."""
    p = _EWPlan()
    p.rows, p.cols, p.x_rs = pl.rows, pl.cols, pl.x_rs
    p.op, p.in_type, p.out_type = op, in_type, out_type
    p.bx, p.by, p.narrow = pl.bx, pl.by, int(pl.narrow)
    p.zp_mode, p.zp_int64, p.nan_to_zero = zp_mode, int(zp_int64), \
        int(nan_to_zero)
    if bit_width:
        p.lo, p.hi, p.lo_f, p.hi_f = _bounds(bit_width)
    if pl.scale is not None:
        p.scale_vec = 1
        _fill(p.sb, pl.scale)
    if pl.zp is not None:
        _fill(p.zb, pl.zp)
    return p


_SCALARS = (float, int, np.floating, np.integer)


def _is_scalar(v) -> bool:
    return isinstance(v, _SCALARS) or (
        not isinstance(v, torch.Tensor) and np.ndim(v) == 0)


def _scale_values(scale: float) -> tuple:
    """A scalar scale by value: in f32, and in f64 for the int64
    dequantize, which the chain multiplies by a float64 tensor of it."""
    return float(np.float32(scale)), float(scale)


def _sig(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.stride())


@functools.lru_cache(maxsize=None)
def _bounds(bit_width: int) -> tuple:
    """The clip bounds in f64 and rounded to f32, as torch.clamp takes
    them for an f64 or an f32 tensor."""
    lo, hi = qrange(bit_width)
    return lo, hi, float(np.float32(lo)), float(np.float32(hi))


def _run(op: str, x: torch.Tensor, out_dtype, type_pair: tuple,
         bit_width: int, scale: float, scale_t, zero_point, zp_t,
         nan_to_zero: bool) -> torch.Tensor:
    """One launch of csrc/elementwise.cu: x (made dense first where it is
    neither dense nor dense rows) -> a new tensor of ``out_dtype``, dense
    in x's memory order."""
    svec = None if scale_t is None else as_tensor(scale_t, x.device)
    zvec = zp_t
    if zvec is not None:
        if zvec.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"zero-point tensors are int32 or int64, "
                            f"not {zvec.dtype}")
        zvec = zvec.to(x.device)
    out_size = out_dtype.itemsize
    pl = plan(tuple(x.shape), x.stride(), x.element_size(), out_size,
              _sig(svec), _sig(zvec))
    if pl.copy:
        # a dense copy with x's dim order, as torch's elementwise ops
        # allocate their outputs
        x = torch.empty_like(x).copy_(x)
        pl = plan(tuple(x.shape), x.stride(), x.element_size(), out_size,
                  _sig(svec), _sig(zvec))
    out = torch.empty_like(x, dtype=out_dtype)
    if x.numel() == 0:
        return out
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{x.numel()} elements exceed the kernel's 32-bit "
                         "index")
    zp_mode = 0 if zero_point is None and zvec is None \
        else 2 if zvec is not None else 1
    p = _plan_struct(pl, _OPS[op], *type_pair, bit_width, zp_mode,
                     zvec is not None and zvec.dtype == torch.int64,
                     nan_to_zero)
    rc = _library().nq_elementwise(
        x.data_ptr(), out.data_ptr(),
        None if svec is None else svec.data_ptr(),
        None if zvec is None else zvec.data_ptr(), ctypes.byref(p),
        *_scale_values(scale),
        0 if zero_point is None else int(zero_point),
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc}")
    return out


def _check_float_in(name: str, x: torch.Tensor, bit_width: int,
                    container) -> None:
    if x.dtype not in _Q_IN:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if container not in _Q_OUT:
        raise TypeError(f"{name} writes int8, int32 or int64, "
                        f"not {container}")
    if not 1 <= bit_width <= (8 if container == torch.int8 else 64):
        raise ValueError(f"{bit_width} bits do not fit {container}")
    if x.device.type not in _DEVICES:
        raise ValueError(f"no {name} kernel for device {x.device}")


def quantize(x: torch.Tensor, bit_width: int, scale, zero_point=None,
             out_dtype=torch.int32) -> torch.Tensor:
    """x (float32 or bfloat16) -> ``out_dtype`` (int8, int32 or int64)
    quantized values at ``bit_width`` bits: rint(clip(x / scale + zp)).
    int64 out adds the zero point in f64 (x64 mode). The result has x's
    shape and is dense in x's memory order. Runs the custom op
    ``nqt::quantize``: CUDA tensors launch the kernel of
    csrc/elementwise.cu (or raise); CPU tensors take
    ``quantize_reference``."""
    _check_float_in("quantize", x, bit_width, out_dtype)
    return torch.ops.nqt.quantize(x, bit_width, *_op_args(x, scale,
                                                         zero_point),
                                  out_dtype)


def dequantize(q: torch.Tensor, scale, zero_point=None,
               out_dtype=torch.float32) -> torch.Tensor:
    """q (int8, int32 or int64) -> ``out_dtype`` (float32 or bfloat16):
    float(q - zp) * scale, in f32 for int8/int32 and as one f64 product
    rounded to f32 for int64 (x64 mode). The result has q's shape and is
    dense in q's memory order. Runs the custom op ``nqt::dequantize``:
    CUDA tensors launch the kernel of csrc/elementwise.cu (or raise); CPU
    tensors take ``dequantize_reference``."""
    if q.dtype not in _D_IN:
        raise TypeError(f"dequantize takes int8, int32 or int64, "
                        f"not {q.dtype}")
    if out_dtype not in _D_OUT:
        raise TypeError(f"dequantize writes float32 or bfloat16, "
                        f"not {out_dtype}")
    if q.device.type not in _DEVICES:
        raise ValueError(f"no dequantize kernel for device {q.device}")
    scale, scale_t, zp, zp_t, _ = _op_args(q, scale, zero_point, int_zp=True)
    return torch.ops.nqt.dequantize(q, scale, scale_t, zp, zp_t, out_dtype)


def fake_quantize(x: torch.Tensor, bit_width: int, scale, zero_point=None,
                  container=torch.int8) -> torch.Tensor:
    """x (float32 or bfloat16) -> float32 ``dequantize(quantize(x, ...,
    container), scale, zero_point)`` in one pass, the integer kept in a
    register: equal to the two wrappers in turn, with one launch in place
    of two and no integer tensor written. Runs the custom op
    ``nqt::fake_quantize``: CUDA tensors launch the kernel of
    csrc/elementwise.cu (or raise); CPU tensors take
    ``fake_quantize_reference``."""
    _check_float_in("fake_quantize", x, bit_width, container)
    return torch.ops.nqt.fake_quantize(
        x, bit_width, *_op_args(x, scale, zero_point, int_zp=True), container)


quantize.launches = 0
dequantize.launches = 0
fake_quantize.launches = 0


# -- the custom ops -------------------------------------------------------
#
# nqt::quantize, nqt::dequantize and nqt::fake_quantize take the scale and
# the zero point each as a value (a float; an int, exact, for the zero
# point a dequantize subtracts) or a tensor: a host array is
# placed on the device before the op (intops.place, once per distinct
# array), so the schema holds no host object. ``nan_to_zero`` is _any_zero
# of the caller's scale, read on the host where it lies there.

_DEVICES = ("cpu", "cuda")


def _op_args(x: torch.Tensor, scale, zero_point, int_zp: bool = False) \
        -> tuple:
    """(scale, scale tensor, zero point, zero-point tensor, nan_to_zero) as
    the ops take them, on x's device; a scalar zero point as a float, or
    with ``int_zp`` as an int (a dequantize subtracts it exactly, also
    past 2^53)."""
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
        zero_point = int(zero_point) if int_zp else float(zero_point)
    return scale, scale_t, zero_point, zp_t, nan_to_zero


def _pick(value, tensor):
    return value if tensor is None else tensor


@torch.library.custom_op("nqt::quantize", mutates_args=(),
                         device_types="cuda")
def _quantize_op(x: torch.Tensor, bit_width: int, scale: float,
                 scale_t: Optional[torch.Tensor], zero_point: Optional[float],
                 zp_t: Optional[torch.Tensor], nan_to_zero: bool,
                 out_dtype: torch.dtype) -> torch.Tensor:
    out = _run("quantize", x, out_dtype, (_Q_IN[x.dtype], _Q_OUT[out_dtype]),
               bit_width, scale, scale_t, zero_point, zp_t, nan_to_zero)
    if x.numel():
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
                   zero_point: Optional[int], zp_t: Optional[torch.Tensor],
                   out_dtype: torch.dtype) -> torch.Tensor:
    out = _run("dequantize", q, out_dtype,
               (_D_IN[q.dtype], _D_OUT[out_dtype]), 0, scale, scale_t,
               zero_point, zp_t, False)
    if q.numel():
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


@torch.library.custom_op("nqt::fake_quantize", mutates_args=(),
                         device_types="cuda")
def _fake_quantize_op(x: torch.Tensor, bit_width: int, scale: float,
                      scale_t: Optional[torch.Tensor],
                      zero_point: Optional[int],
                      zp_t: Optional[torch.Tensor], nan_to_zero: bool,
                      container: torch.dtype) -> torch.Tensor:
    out = _run("fake_quantize", x, torch.float32,
               (_Q_IN[x.dtype], _Q_OUT[container]), bit_width, scale,
               scale_t, zero_point, zp_t, nan_to_zero)
    if x.numel():
        fake_quantize.launches += 1
    return out


@_fake_quantize_op.register_kernel("cpu")
def _fake_quantize_cpu(x, bit_width, scale, scale_t, zero_point, zp_t,
                       nan_to_zero, container):
    s, zp = _pick(scale, scale_t), _pick(zero_point, zp_t)
    q = _quantize_plain(x, bit_width, s, zp, container, nan_to_zero)
    y = dequantize_reference(q, s, zp)
    return torch.empty_like(x, dtype=torch.float32).copy_(y)


@_fake_quantize_op.register_fake
def _fake_quantize_fake(x, bit_width, scale, scale_t, zero_point, zp_t,
                        nan_to_zero, container):
    return torch.empty_like(x, dtype=torch.float32)


def _library() -> ctypes.CDLL:
    lib = load("elementwise")
    if not getattr(lib, "_nq_typed", False):
        fn = lib.nq_elementwise
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(_EWPlan), ctypes.c_float, ctypes.c_double,
            ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._nq_typed = True
    return lib
