"""Tensor layer: FTensor / ITensor / QTensor and class-preserving helpers.

Port of ``numpy_quant_tpu/tensor.py``:

* ``ITensor`` holds a host numpy int64 array -- the shape domain. Shape
  computations (Shape -> Gather -> Unsqueeze -> Concat -> Reshape) run on
  the host and never touch the device.
* ``FTensor`` wraps a float tensor on the model's device (float32, or
  bfloat16 under ``config.low_precision_floats``).
* ``QTensor`` wraps an integer tensor (int32 container, or int8 storage
  for constants of <= 8 bits) plus (bit_width, scale) and a zero_point
  that is None, a host integer or an int32 correction tensor.
* ``PackedQTensor`` holds a 2-D symmetric weight packed to exactly
  bit_width bits per value (kernels/pack.py), made by ``pack_qtensor``.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from . import config
from .ops.conv import conv2d_nchw, extract_patches_exact
from .ops.erf import erf as _erf
from .quantization import (
    dequantize as _dequantize,
    q_matmul,
    quantize as _quantize,
    requantize as _requantize,
)


def _take(data: torch.Tensor, indices, axis: int) -> torch.Tensor:
    """ONNX Gather of a device tensor by host indices; a rank-0 index
    removes the axis."""
    idx = np.asarray(indices, dtype=np.int64)
    idx = np.where(idx < 0, idx + data.shape[axis], idx)
    flat = torch.as_tensor(idx.reshape(-1), device=data.device)
    out = torch.index_select(data, axis, flat)
    return out.reshape(tuple(data.shape[:axis]) + idx.shape
                       + tuple(data.shape[axis + 1:]))


def _expand_dims(data: torch.Tensor, axes) -> torch.Tensor:
    out_ndim = data.ndim + len(axes)
    for a in sorted(int(a) % out_ndim for a in axes):
        data = data.unsqueeze(a)
    return data


def _permute(data: torch.Tensor, axes) -> torch.Tensor:
    if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
        axes = axes[0]
    if not axes:
        axes = tuple(reversed(range(data.ndim)))
    return data.permute(*(int(a) for a in axes))


class ITensor:
    """Integer/shape-domain tensor, host-resident."""

    def __init__(self, data):
        self._data = np.asarray(data, dtype=np.int64)

    @property
    def data(self) -> np.ndarray:
        return self._data

    @property
    def shape(self) -> "ITensor":
        return ITensor(np.array(self._data.shape, dtype=np.int64))

    @property
    def size(self) -> int:
        return self._data.size

    def copy(self) -> "ITensor":
        return ITensor(self._data.copy())

    def expand_dims(self, axis: "ITensor") -> "ITensor":
        return ITensor(np.expand_dims(self._data, axis=tuple(axis.data)))

    def __eq__(self, other: "ITensor"):
        return ITensor(np.array(self._data == other.data, np.int64))

    def take(self, indices: "ITensor", axis: int):
        return ITensor(self._data.take(indices.data, axis))

    def __getitem__(self, ind) -> "ITensor":
        return ITensor(self._data.__getitem__(ind))

    def __repr__(self):
        return f"ITensor({self._data!r})"


def _as_float(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        raise ValueError(f"Use a float tensor for FTensor, got {type(x)}")
    target = config.float_dtype
    return x if x.dtype == target else x.to(target)


class FTensor:
    """Float device tensor (float32; bfloat16 under
    config.low_precision_floats)."""

    def __init__(self, data):
        self._data = _as_float(data)

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def shape(self) -> ITensor:
        return ITensor(np.array(self._data.shape, dtype=np.int64))

    @property
    def T(self) -> "FTensor":
        return FTensor(_permute(self._data, ()))

    def copy(self) -> "FTensor":
        return FTensor(self._data)

    def reshape(self, shape: ITensor) -> "FTensor":
        return FTensor(self._data.reshape(tuple(int(d) for d in shape.data)))

    def take(self, indices: ITensor, axis: int) -> "FTensor":
        return FTensor(_take(self._data, indices.data, axis))

    def transpose(self, *axes) -> "FTensor":
        return FTensor(_permute(self._data, axes))

    def __getitem__(self, ind) -> "FTensor":
        """Basic slicing (Slice, Split); a negative step selects the
        indices it names, which torch's slicing does not take."""
        if not isinstance(ind, tuple):
            ind = (ind,)
        data = self._data
        plain = []
        for axis, sl in enumerate(ind):
            if isinstance(sl, slice) and sl.step is not None and sl.step < 0:
                idx = torch.arange(*sl.indices(data.shape[axis]),
                                   device=data.device)
                data = torch.index_select(data, axis, idx)
                sl = slice(None)
            plain.append(sl)
        return FTensor(data[tuple(plain)])

    def __neg__(self) -> "FTensor":
        return FTensor(-self._data)

    def __mul__(self, other: "FTensor") -> "FTensor":
        if isinstance(other, FTensor):
            return FTensor(self._data * other.data)
        raise ValueError(f"Value of type {type(other)} cannot be multiplied")

    def __add__(self, other) -> "FTensor":
        if isinstance(other, FTensor):
            return FTensor(self._data + other.data)
        if isinstance(other, float):
            return FTensor(self._data + torch.full(
                (), other, dtype=self._data.dtype, device=self._data.device))
        raise ValueError(f"Value of type {type(other)} cannot be added")

    def expand_dims(self, axis: ITensor) -> "FTensor":
        return FTensor(_expand_dims(self._data, axis.data.reshape(-1)))

    def matmul(self, other: "FTensor") -> "FTensor":
        return FTensor(torch.matmul(self._data, other.data))

    def div(self, other: "FTensor") -> "FTensor":
        return FTensor(self._data / other.data)

    def erf(self) -> "FTensor":
        return FTensor(_erf(self._data))

    def exp(self) -> "FTensor":
        return FTensor(torch.exp(self._data))

    def expand(self, shape: ITensor) -> "FTensor":
        # ONNX Expand: target dims of 1 keep the (larger) current dim
        curr_shape = np.array(self._data.shape, dtype=np.int64)
        new_shape = np.array(shape.data, copy=True)
        if new_shape.size < curr_shape.size:
            new_shape = np.concatenate(
                [curr_shape[:curr_shape.size - new_shape.size], new_shape])
        pad = new_shape.size - curr_shape.size
        curr_padded = np.concatenate([np.ones(pad, dtype=np.int64), curr_shape])
        adjust = np.logical_and(new_shape < curr_padded, new_shape == 1)
        new_shape[adjust] = curr_padded[adjust]
        return FTensor(torch.broadcast_to(
            self._data, tuple(int(d) for d in new_shape)))

    def inv(self) -> "FTensor":
        return FTensor(1 / self._data)

    def max(self, axis: int, keepdims: bool) -> "FTensor":
        return FTensor(torch.amax(self._data, dim=axis, keepdim=keepdims))

    def mean(self, axis, keepdims: bool) -> "FTensor":
        return FTensor(torch.mean(self._data, dim=axis, keepdim=keepdims))

    def sum(self, axis: int, keepdims: bool) -> "FTensor":
        return FTensor(torch.sum(self._data, dim=axis, keepdim=keepdims))

    def softmax(self, axis: int) -> "FTensor":
        # max-subtracted, the reference's composition
        m = self + (-(self.max(axis=axis, keepdims=True)))
        e = m.exp()
        return e.div(e.sum(axis=axis, keepdims=True))

    def sqrt(self) -> "FTensor":
        return FTensor(torch.sqrt(self._data))

    def __repr__(self):
        return f"FTensor(shape={tuple(self._data.shape)})"


def _is_tensor_zp(zp) -> bool:
    return isinstance(zp, torch.Tensor) and zp.ndim > 0


class QTensor:
    """Quantized tensor: integer data + (bit_width, scale, zero_point).

    ``scale`` is a host numpy float32 scalar or array; ``zero_point`` is
    None, a host integer, or an int32 correction tensor (matmul
    accumulators). ``colsum``: precomputed column sums of a weight
    constant, fed to the q_matmul correction."""

    def __init__(self, data: torch.Tensor, bit_width: int, scale,
                 zero_point: Optional[Any] = None, colsum=None):
        self._data = data
        self.bit_width = int(bit_width)
        self.scale = scale
        self.zero_point = zero_point
        self.colsum = colsum

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def T(self) -> "QTensor":
        zp = self.zero_point
        if _is_tensor_zp(zp):
            zp = _permute(zp, ())
        scale = self.scale
        if getattr(scale, "ndim", 0) > 0:
            scale = scale.T
        return QTensor(_permute(self._data, ()), self.bit_width, scale, zp)

    def copy(self) -> "QTensor":
        return QTensor(self._data, self.bit_width, self.scale, self.zero_point)

    def reshape(self, shape: ITensor) -> "QTensor":
        return QTensor(self._data.reshape(tuple(int(d) for d in shape.data)),
                       self.bit_width, self.scale, self.zero_point)

    def transpose(self, *axes) -> "QTensor":
        zp = self.zero_point
        if _is_tensor_zp(zp):
            zp = _permute(zp, axes)
        scale = self.scale
        if getattr(scale, "ndim", 0) > 0:
            scale = np.transpose(scale, *axes)
        return QTensor(_permute(self._data, axes), self.bit_width, scale, zp)

    def __add__(self, other: "QTensor") -> "QTensor":
        if isinstance(other, QTensor):
            return QTensor(self._data + other.data, self.bit_width,
                           self.scale, self.zero_point)
        raise ValueError(f"Cannot add QTensor with {other.__class__}")

    def take(self, indices: ITensor, axis: int) -> "QTensor":
        """ONNX Gather in the quantized domain: same integers, same
        params (per-tensor scales only)."""
        if getattr(self.scale, "ndim", 0) > 0:
            raise ValueError("Gather on a per-channel QTensor is not "
                             "supported (dequantize first)")
        zp = self.zero_point
        if _is_tensor_zp(zp):
            zp = _take(zp, indices.data, axis)
        return QTensor(_take(self._data, indices.data, axis),
                       self.bit_width, self.scale, zp)

    def dequantize(self) -> FTensor:
        return FTensor(_dequantize(self._data, self.scale, self.zero_point))

    def requantize(self, bit_width: int, scale, zero_point) -> "QTensor":
        qdata = _requantize(self._data, self.scale, self.zero_point,
                            res_scale=scale, res_zero_point=zero_point,
                            bit_width=bit_width)
        return QTensor(qdata, bit_width, scale, zero_point)

    def matmul(self, other: "QTensor") -> "QTensor":
        # mixed widths accumulate at 4x the wider operand's width
        bit_width = max(self.bit_width, other.bit_width)
        y, scale, zero_point = q_matmul(
            self._data, self.scale, self.zero_point,
            other._data, other.scale, other.zero_point,
            bit_width=bit_width, b_colsum=other.colsum)
        return QTensor(y, 4 * bit_width, scale, zero_point)

    def __repr__(self):
        return (f"QTensor(shape={self.shape}, bit_width={self.bit_width}, "
                f"scale={self.scale})")


class PackedQTensor:
    """A 2-D symmetric quantized weight in packed storage (exactly
    bit_width bits per value) plus its precomputed int32 column sums
    [1, N] for the zero-point correction. Layouts (kernels/pack.py):

    * ``"splitk"`` (bits 1/2/4; 8 = the plain int8 weight): [KR, N];
    * ``"bitplanes"`` (any bits, e.g. 3/5/6/7): uint8[b, ceil(K/8), N].

    ``scale`` is a host float32 scalar (per tensor), [1, N] (per output
    channel) or [K/g, N] (grouped, ``Model.quantize_weights(group_size=)``).
    The payload and colsum live on the model's device; the MatMul either
    unpacks to int8 (``config.packed_execution == "unpack"``) or runs the
    packed kernels of kernels/qmatmul.py on it."""

    def __init__(self, planes: torch.Tensor, colsum: torch.Tensor, k: int,
                 n: int, bit_width: int, scale, layout: str = "bitplanes"):
        if layout not in ("splitk", "bitplanes"):
            raise ValueError(f"unknown packed layout {layout!r}")
        self.planes = planes
        self.colsum = colsum
        self.k = int(k)
        self.n = int(n)
        self.bit_width = int(bit_width)
        self.scale = scale
        self.zero_point = None  # packing requires symmetric weights
        self.layout = layout
        self._scale_vec = None

    @property
    def shape(self):
        return (self.k, self.n)

    @property
    def data(self) -> torch.Tensor:
        return self.planes

    def to(self, device) -> "PackedQTensor":
        return PackedQTensor(self.planes.to(device), self.colsum.to(device),
                             self.k, self.n, self.bit_width, self.scale,
                             self.layout)

    def scale_vec(self):
        """The scale as an f32 tensor on the payload's device (made once):
        [1, N] per channel, [K/g, N] grouped; None for a per-tensor
        scale."""
        if getattr(self.scale, "ndim", 0) == 0:
            return None
        if self._scale_vec is None:
            s = np.asarray(self.scale, np.float32)
            self._scale_vec = torch.from_numpy(
                s.reshape(-1, self.n)).to(self.planes.device)
        return self._scale_vec

    def unpack(self) -> QTensor:
        from .kernels.pack import unpack_bitplanes, unpack_splitk
        if self.layout == "splitk":
            vals = self.planes if self.bit_width == 8 else \
                unpack_splitk(self.planes, self.bit_width, self.k)
        else:
            vals = unpack_bitplanes(self.planes, self.bit_width, self.k)
        return QTensor(vals.to(torch.int8), self.bit_width, self.scale, None,
                       colsum=self.colsum)

    def __repr__(self):
        return (f"PackedQTensor(shape=({self.k}, {self.n}), "
                f"bit_width={self.bit_width}, layout={self.layout!r})")


def pack_qtensor(qt: QTensor) -> PackedQTensor:
    """2-D symmetric QTensor -> packed weight on the same device: the
    split-K layout at bits 1/2/4/8, bit-planes at odd widths."""
    from .kernels.pack import pack_bitplanes, pack_splitk
    if qt.zero_point is not None or qt.data.ndim != 2 or qt.bit_width > 8:
        raise ValueError("only 2-D symmetric weights of <= 8 bits pack")
    device = qt.data.device
    data = qt.data.cpu().numpy()
    k, n = data.shape
    colsum = data.astype(np.int64).sum(axis=0, keepdims=True).astype(np.int32)
    if qt.bit_width == 8:
        payload, layout = data.astype(np.int8), "splitk"
    elif qt.bit_width in (1, 2, 4):
        payload, layout = pack_splitk(data, qt.bit_width), "splitk"
    else:
        payload, layout = pack_bitplanes(data, qt.bit_width), "bitplanes"
    return PackedQTensor(torch.from_numpy(payload).to(device),
                         torch.from_numpy(colsum).to(device), k, n,
                         qt.bit_width, qt.scale, layout=layout)


Tensor = Union[ITensor, FTensor, QTensor, PackedQTensor]


def quantize_tensor(tensor: FTensor, bit_width: int, scale, zero_point) -> QTensor:
    qdata = _quantize(tensor.data, bit_width, scale, zero_point)
    return QTensor(qdata, bit_width, scale=scale, zero_point=zero_point)


def concat(x_list: list, axis: int):
    assert all(x.__class__ == x_list[0].__class__ for x in x_list), (
        f"types {[x.__class__ for x in x_list]} of x_list entries do not match")
    first = x_list[0]
    if isinstance(first, ITensor):
        return ITensor(np.concatenate([x.data for x in x_list], axis=axis))
    if isinstance(first, FTensor):
        return FTensor(torch.cat([x.data for x in x_list], dim=axis))
    raise ValueError(f"concat of {type(first)} not supported")


def where(condition: ITensor, a: Tensor, b: Tensor):
    assert a.__class__ == b.__class__, \
        f"types {a.__class__} and {b.__class__} do not match"
    if isinstance(a, ITensor):
        return ITensor(np.where(condition.data, a.data, b.data))
    if isinstance(a, FTensor):
        cond = torch.as_tensor(condition.data != 0, device=a.data.device)
        return FTensor(torch.where(cond, a.data, b.data))
    raise ValueError(f"where of {type(a)} not supported")


def fconv2d(x: FTensor, w: FTensor, b: FTensor, pads, strides,
            dilations=(1, 1), group=1) -> FTensor:
    """Float conv2d on NCHW input."""
    return FTensor(conv2d_nchw(x.data, w.data, b.data if b is not None else None,
                               pads, strides, dilations, group))


def qconv2d(x: QTensor, w: QTensor, b: Optional[QTensor], pads, strides,
            dilations=(1, 1), group=1) -> QTensor:
    """Integer conv2d: im2col + one int8 product (``q_matmul``).

    x: NCHW QTensor (asymmetric activations pad with their zero point);
    w: [O, C, KH, KW] symmetric QTensor; b: optional 4x-bit-width bias at
    scale sx*sw. Returns a 4x-bit-width accumulator QTensor. Grouped
    convs are not ported."""
    if int(group) != 1:
        raise NotImplementedError("grouped integer Conv is not ported")
    bit_width = max(x.bit_width, w.bit_width)
    o, c, kh, kw = w.data.shape
    assert x.data.shape[1] == c, (x.data.shape, w.data.shape)
    zp_x = x.zero_point
    pad_value = 0 if zp_x is None else int(zp_x)

    xd = x.data.permute(0, 2, 3, 1)  # NHWC
    patches = extract_patches_exact(xd, (kh, kw), pads, strides, pad_value,
                                    dilations)
    bsz, oh, ow, kkc = patches.shape
    w2d = w.data.permute(2, 3, 1, 0).reshape(kh * kw * c, o)
    acc, scale, zp = q_matmul(patches.reshape(bsz * oh * ow, kkc),
                              x.scale, x.zero_point,
                              w2d, w.scale, w.zero_point,
                              bit_width=bit_width)
    acc = acc.reshape(bsz, oh, ow, o).permute(0, 3, 1, 2)  # NCHW
    if zp is not None:
        if zp.shape[-2] == 1:
            # w-colsum * zp_x correction: [1, O] -> NCHW broadcast shape
            zp = zp.reshape(1, o, 1, 1)
        else:
            zp = torch.broadcast_to(zp, (bsz * oh * ow, o)).reshape(
                bsz, oh, ow, o).permute(0, 3, 1, 2)
    if np.asarray(scale, np.float32).ndim > 0:
        scale = np.asarray(scale, np.float32).reshape(1, o, 1, 1)
    out = QTensor(acc, 4 * bit_width, scale, zp)
    if b is not None:
        bias = b.data.reshape(1, o, 1, 1)
        out = QTensor(out.data + bias, out.bit_width, out.scale, out.zero_point)
    return out
