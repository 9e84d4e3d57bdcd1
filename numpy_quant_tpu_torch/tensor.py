"""Tensor layer: FTensor / ITensor / QTensor and class-preserving helpers.

Port of ``numpy_quant_tpu/tensor.py``:

* ``ITensor`` holds a host numpy int64 array -- the shape domain. Shape
  computations (Shape -> Gather -> Unsqueeze -> Concat -> Reshape) run on
  the host and never touch the device.
* ``DITensor`` holds a device int32 tensor: data-dependent integers
  (ArgMax/TopK indices, comparison masks) whose values the host never
  reads, so a captured forward stays free of host syncs.
* ``FTensor`` wraps a float tensor on the model's device (float32, or
  bfloat16 under ``config.low_precision_floats``).
* ``QTensor`` wraps an integer tensor (int32 container, or int8 storage
  for constants of <= 8 bits; int64 containers in a model above 8 bits)
  plus (bit_width, scale) and a zero_point that is None, a host integer
  or an int32 (int64) correction tensor.
* ``PackedQTensor`` holds a 2-D symmetric weight packed to exactly
  bit_width bits per value (kernels/pack.py), made by ``pack_qtensor``.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from . import config
from .intops import (as_tensor, place, replays_xla, xla_cpu_exp,
                     xla_cpu_row_sum)
from .ops.conv import conv2d_nchw, extract_patches_exact
from .ops.erf import erf as _erf
from .quantization import (
    dequantize as _dequantize,
    q_matmul,
    quant_parameters,
    quantize as _quantize,
    requantize as _requantize,
)


def _take(data: torch.Tensor, indices, axis: int) -> torch.Tensor:
    """ONNX Gather of a device tensor by host indices (a numpy array) or
    device indices (a tensor, DITensor data); a rank-0 index removes the
    axis. Negative indices count from the end, as ``jnp.take``'s do."""
    axis = axis % data.ndim
    if isinstance(indices, torch.Tensor):
        idx = indices.to(device=data.device, dtype=torch.int64)
        idx = torch.where(idx < 0, idx + data.shape[axis], idx)
        flat, idx_shape = idx.reshape(-1), tuple(idx.shape)
    else:
        idx = np.asarray(indices, dtype=np.int64)
        idx = np.where(idx < 0, idx + data.shape[axis], idx)
        flat = place(idx.reshape(-1), data.device, torch.int64)
        idx_shape = idx.shape
    out = torch.index_select(data, axis, flat)
    return out.reshape(tuple(data.shape[:axis]) + idx_shape
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
    """Integer/shape-domain tensor, host-resident. ``orig_dtype``: the
    narrow numpy dtype of an imported int8/uint8/int16/uint16 payload
    (QDQ weights and zero points), whose storage range QuantizeLinear and
    the QLinear ops read; ``placed``: the same values on the model's
    device, placed once at import for the ops that consume them there
    (graph.import_onnx)."""

    def __init__(self, data, orig_dtype=None, placed=None):
        self._data = np.asarray(data, dtype=np.int64)
        self.orig_dtype = orig_dtype
        self.placed = placed

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
        return ITensor(self._data.copy(), self.orig_dtype, self.placed)

    def on(self, device) -> torch.Tensor:
        """The values as an int32 device tensor (int8 where the placed
        copy is int8): the placed copy, else moved from the host."""
        if self.placed is not None:
            return self.placed
        return place(self._data, device, torch.int32)

    def expand_dims(self, axis: "ITensor") -> "ITensor":
        return ITensor(np.expand_dims(self._data, axis=tuple(axis.data)))

    def __neg__(self) -> "ITensor":
        return ITensor(-self._data)

    def __eq__(self, other: "ITensor"):
        return ITensor(np.array(self._data == other.data, np.int64))

    def __add__(self, other: "ITensor") -> "ITensor":
        return ITensor(self._data + other.data)

    def __mul__(self, other: "ITensor") -> "ITensor":
        return ITensor(self._data * other.data)

    def reshape(self, shape: "ITensor") -> "ITensor":
        return ITensor(self._data.reshape(tuple(shape.data)))

    def transpose(self, axes=None) -> "ITensor":
        return ITensor(self._data.transpose(axes))

    def take(self, indices: "ITensor", axis: int):
        return ITensor(self._data.take(indices.data, axis))

    def __getitem__(self, ind) -> "ITensor":
        return ITensor(self._data.__getitem__(ind))

    def __repr__(self):
        return f"ITensor({self._data!r})"


class DITensor:
    """Device integer tensor (int32): data-dependent integers -- ArgMax and
    TopK indices, comparison and logical masks -- whose values are not
    known until the forward runs, the third domain beside the host
    ITensor and the device FTensor (JAX ``tensor.py``'s DITensor). Nothing
    reads them on the host: an op that needs host values (a Reshape
    target, an If condition) raises on one."""

    def __init__(self, data):
        if not isinstance(data, torch.Tensor) or data.is_floating_point() \
                or data.dtype == torch.bool or data.is_complex():
            raise ValueError(f"DITensor needs integer data, got "
                             f"{getattr(data, 'dtype', type(data))}")
        self._data = data.to(torch.int32)

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def shape(self) -> ITensor:
        return ITensor(np.array(self._data.shape, dtype=np.int64))

    @property
    def size(self) -> int:
        return self._data.numel()

    def copy(self) -> "DITensor":
        return DITensor(self._data)

    def reshape(self, shape: ITensor) -> "DITensor":
        return DITensor(self._data.reshape(tuple(int(d) for d in shape.data)))

    def transpose(self, *axes) -> "DITensor":
        return DITensor(_permute(self._data, axes))

    def expand_dims(self, axis: ITensor) -> "DITensor":
        return DITensor(_expand_dims(self._data, axis.data.reshape(-1)))

    def __getitem__(self, ind) -> "DITensor":
        return DITensor(self._data[ind])

    def take(self, indices, axis: int) -> "DITensor":
        return DITensor(_take(self._data, indices.data, axis))

    def __repr__(self):
        return f"DITensor(shape={tuple(self._data.shape)})"


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
        """The same tensor; a small constant's host copy rides along."""
        t = FTensor(self._data)
        host = getattr(self, "host", None)
        if host is not None:
            t.host = host
        return t

    def reshape(self, shape: ITensor) -> "FTensor":
        return FTensor(self._data.reshape(tuple(int(d) for d in shape.data)))

    def take(self, indices, axis: int) -> "FTensor":
        """Gather by host (ITensor) or device (DITensor) indices."""
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

    def __radd__(self, other) -> "FTensor":
        return self.__add__(other)

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

    def _xla_axis(self, axis):
        """The one axis of a float32 CPU tensor over which its sum or mean
        replays XLA's CPU order (``intops.xla_cpu_row_sum``), so a CPU walk's
        LayerNorm and ReduceMean equal JAX's bit for bit; None elsewhere,
        where torch's order stands (the card's kernels replay torch's)."""
        d = self._data
        if isinstance(axis, (tuple, list)) and len(axis) == 1:
            axis = axis[0]
        if d.device.type == "cpu" and d.dtype == torch.float32 \
                and isinstance(axis, int) and d.shape[axis] > 0:
            return axis
        return None

    def mean(self, axis, keepdims: bool) -> "FTensor":
        ax = self._xla_axis(axis)
        if ax is None:
            return FTensor(torch.mean(self._data, dim=axis, keepdim=keepdims))
        # XLA's mean: the sum times float32(1/n), a float32 product
        s = xla_cpu_row_sum(self._data, ax) \
            * float(np.float32(1.0 / self._data.shape[ax]))
        return FTensor(s.unsqueeze(ax) if keepdims else s)

    def relu(self) -> "FTensor":
        # the JAX package's (x > 0) * x (torch.relu keeps -0.0 apart)
        return FTensor((self._data > 0) * self._data)

    def sum(self, axis: int, keepdims: bool) -> "FTensor":
        ax = self._xla_axis(axis)
        if ax is None:
            return FTensor(torch.sum(self._data, dim=axis, keepdim=keepdims))
        s = xla_cpu_row_sum(self._data, ax)
        return FTensor(s.unsqueeze(ax) if keepdims else s)

    def sigmoid(self) -> "FTensor":
        # the JAX package's composition 1 / (1 + exp(-x)), not
        # torch.sigmoid (other roundings)
        return ((-self).exp() + 1.0).inv()

    def softmax(self, axis: int) -> "FTensor":
        # max-subtracted, the reference's composition
        m = self + (-(self.max(axis=axis, keepdims=True)))
        if replays_xla(m.data):
            # XLA's CPU exp and row-sum order, as the attention kernels'
            # plain versions take them on CPU tensors (fused == unfused)
            e = xla_cpu_exp(m.data)
            return FTensor(e / xla_cpu_row_sum(e, axis).unsqueeze(axis))
        e = m.exp()
        # torch's order elsewhere: the attention kernels' plain versions
        # sum softmax rows so, and fused == unfused holds on the card
        return e.div(FTensor(torch.sum(e.data, dim=axis, keepdim=True)))

    def sqrt(self) -> "FTensor":
        d = self._data
        if d.device.type == "cpu" and d.dtype == torch.float32:
            # torch's vectorized CPU sqrt is an ulp off IEEE on ~1% of
            # inputs; XLA's and the card's are IEEE. The float64 root
            # rounds to the IEEE float32 one (53 >= 2·24 + 2 bits)
            return FTensor(torch.sqrt(d.double()).float())
        return FTensor(torch.sqrt(d))

    def tanh(self) -> "FTensor":
        return FTensor(torch.tanh(self._data))

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
                 zero_point: Optional[Any] = None, colsum=None,
                 orig_dtype=None):
        self._data = data
        self.bit_width = int(bit_width)
        self.scale = scale
        self.zero_point = zero_point
        self.colsum = colsum
        # storage dtype of a QuantizeLinear / QLinear* output (uint8
        # storage counts one more signed-range bit: ops/interop.py)
        self.orig_dtype = orig_dtype

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

    def __getitem__(self, ind) -> "QTensor":
        zp = self.zero_point
        if _is_tensor_zp(zp):
            zp = zp[ind]
        return QTensor(self._data[ind], self.bit_width, self.scale, zp)

    def expand_dims(self, axis: ITensor) -> "QTensor":
        axes = axis.data.reshape(-1)
        zp = self.zero_point
        if _is_tensor_zp(zp):
            zp = _expand_dims(zp, axes)
        return QTensor(_expand_dims(self._data, axes), self.bit_width,
                       self.scale, zp)

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
        # straight to the float data plane's dtype (bf16 in serving mode)
        return FTensor(_dequantize(self._data, self.scale, self.zero_point,
                                   dtype=config.float_dtype))

    def sigmoid(self) -> "QTensor":
        """Dequantize, float sigmoid, quantize with the same params."""
        act = self.dequantize().sigmoid()
        return QTensor(_quantize(act.data, self.bit_width, self.scale,
                                 self.zero_point, self._data.dtype),
                       self.bit_width, self.scale, self.zero_point)

    def relu(self) -> "QTensor":
        """max(q, zero point): the quantized zero, as JAX computes it."""
        zp = 0 if self.zero_point is None else self.zero_point
        zp = as_tensor(zp, self._data.device, self._data.dtype)
        return QTensor(torch.maximum(self._data, zp), self.bit_width,
                       self.scale, self.zero_point)

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
    * ``"bitplanes"`` (any bits, e.g. 3/5/6/7): uint8[b, ceil(K/8), N];
    * ``"splitk_stacked"`` (bits 1/2/4/8): [S, KR_local, N], S row groups
      of ceil(K/S) rows each packed on its own (pad rows hold 0), one per
      tensor-parallel rank of a row-sharded weight; the colsum is global.

    ``scale`` is a host float32 scalar (per tensor), [1, N] (per output
    channel) or [K/g, N] (grouped, ``Model.quantize_weights(group_size=)``).
    The payload and colsum live on the model's device; the MatMul either
    unpacks to int8 (``config.packed_execution == "unpack"``) or runs the
    packed kernels of kernels/qmatmul.py on it."""

    def __init__(self, planes: torch.Tensor, colsum: torch.Tensor, k: int,
                 n: int, bit_width: int, scale, layout: str = "bitplanes"):
        if layout not in ("splitk", "bitplanes", "splitk_stacked"):
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
            self._scale_vec = place(s.reshape(-1, self.n),
                                    self.planes.device, torch.float32)
        return self._scale_vec

    def unpack(self) -> QTensor:
        from .kernels.pack import unpack_bitplanes, unpack_splitk
        if self.layout == "splitk_stacked":
            s = self.planes.shape[0]
            kl = -(-self.k // s)
            groups = [self.planes[t] if self.bit_width == 8
                      else unpack_splitk(self.planes[t], self.bit_width, kl)
                      for t in range(s)]
            vals = torch.cat([g[:kl] for g in groups], 0)[:self.k]
        elif self.layout == "splitk":
            vals = self.planes if self.bit_width == 8 else \
                unpack_splitk(self.planes, self.bit_width, self.k)
        else:
            vals = unpack_bitplanes(self.planes, self.bit_width, self.k)
        return QTensor(vals.to(torch.int8), self.bit_width, self.scale, None,
                       colsum=self.colsum)

    def __repr__(self):
        return (f"PackedQTensor(shape=({self.k}, {self.n}), "
                f"bit_width={self.bit_width}, layout={self.layout!r})")


def pack_qtensor(qt: QTensor, shards: int = 1) -> PackedQTensor:
    """2-D symmetric QTensor -> packed weight on the same device: the
    split-K layout at bits 1/2/4/8, bit-planes at odd widths.

    ``shards > 1`` (bits 1/2/4/8): each of S contiguous row groups packs on
    its own into a stacked [S, KR_local, N] payload (``splitk_stacked``)
    whose leading axis a tensor-parallel mesh splits: a flat split-K
    payload interleaves K segments and cannot be row-sliced. Pad rows hold
    0 and add nothing to products or the colsum."""
    from .kernels.pack import pack_bitplanes, pack_splitk
    if qt.zero_point is not None or qt.data.ndim != 2 or qt.bit_width > 8:
        raise ValueError("only 2-D symmetric weights of <= 8 bits pack")
    device = qt.data.device
    data = qt.data.cpu().numpy()
    k, n = data.shape
    colsum = data.astype(np.int64).sum(axis=0, keepdims=True).astype(np.int32)
    if shards > 1 and qt.bit_width in (1, 2, 4, 8):
        kl = -(-k // shards)
        padded = np.zeros((shards * kl, n), np.int32)
        padded[:k] = data
        if qt.bit_width == 8:
            payload = padded.astype(np.int8).reshape(shards, kl, n)
        else:
            payload = np.stack([pack_splitk(padded[t * kl:(t + 1) * kl],
                                            qt.bit_width)
                                for t in range(shards)])
        layout = "splitk_stacked"
    elif qt.bit_width == 8:
        payload, layout = data.astype(np.int8), "splitk"
    elif qt.bit_width in (1, 2, 4):
        payload, layout = pack_splitk(data, qt.bit_width), "splitk"
    else:
        payload, layout = pack_bitplanes(data, qt.bit_width), "bitplanes"
    return PackedQTensor(torch.from_numpy(payload).to(device),
                         torch.from_numpy(colsum).to(device), k, n,
                         qt.bit_width, qt.scale, layout=layout)


Tensor = Union[ITensor, DITensor, FTensor, QTensor, PackedQTensor]


def quantize_tensor(tensor: FTensor, bit_width: int, scale, zero_point,
                    container: torch.dtype = None) -> QTensor:
    """``container``: the integer dtype of the data (quantization.quantize's
    default by bit width when None)."""
    qdata = _quantize(tensor.data, bit_width, scale, zero_point, container)
    return QTensor(qdata, bit_width, scale=scale, zero_point=zero_point)


def tensor_min_max(tensor: Tensor):
    """Global (min, max) as float32 host scalars, clamped to include 0."""
    data = tensor.data
    zero = np.float32(0.0)
    if isinstance(data, np.ndarray):
        return (np.minimum(data.min(), zero).astype(np.float32),
                np.maximum(data.max(), zero).astype(np.float32))
    d = data.to(torch.float32)
    return (np.minimum(np.float32(d.min().item()), zero),
            np.maximum(np.float32(d.max().item()), zero))


def quantize_tensor_min_max(tensor: Tensor, bit_width: int,
                            asymmetric: bool) -> QTensor:
    """Quantize with params from the tensor's own clamped min/max."""
    min_val, max_val = tensor_min_max(tensor)
    scale, zero_point = quant_parameters(min_val, max_val, bit_width,
                                         asymmetric)
    return quantize_tensor(tensor, bit_width, scale, zero_point)


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
        cond = place(condition.data != 0, a.data.device, torch.bool)
        return FTensor(torch.where(cond, a.data, b.data))
    raise ValueError(f"where of {type(a)} not supported")


def fconv2d(x: FTensor, w: FTensor, b: FTensor, pads, strides,
            dilations=(1, 1), group=1) -> FTensor:
    """Float conv2d on NCHW input."""
    return FTensor(conv2d_nchw(x.data, w.data, b.data if b is not None else None,
                               pads, strides, dilations, group))


def qconv2d(x: QTensor, w: QTensor, b: Optional[QTensor], pads, strides,
            dilations=(1, 1), group=1) -> QTensor:
    """Integer conv2d: im2col + one integer product (``q_matmul``: int8
    up to 8 bits, the exact int64 product above).

    x: NCHW QTensor (asymmetric activations pad with their zero point);
    w: [O, C/group, KH, KW] symmetric QTensor; b: optional 4x-bit-width
    bias at scale sx*sw. Returns a 4x-bit-width accumulator QTensor. A
    grouped conv runs as ONE batched integer product over the group axis,
    [G, M, KH*KW*C/G] x [G, KH*KW*C/G, O/G] (``int_matmul``'s exact
    float64 batched product; JAX ``tensor.py::qconv2d``), its per-channel
    scales and zero-point correction following the group split."""
    bit_width = max(x.bit_width, w.bit_width)
    o, cg, kh, kw = w.data.shape
    g = int(group)
    c = cg * g
    assert x.data.shape[1] == c, (x.data.shape, w.data.shape, g)
    assert o % g == 0, (o, g)
    zp_x = x.zero_point
    pad_value = 0 if zp_x is None else int(zp_x)

    xd = x.data.permute(0, 2, 3, 1)  # NHWC
    patches = extract_patches_exact(xd, (kh, kw), pads, strides, pad_value,
                                    dilations)
    bsz, oh, ow, kkc = patches.shape
    if g == 1:
        w2d = w.data.permute(2, 3, 1, 0).reshape(kh * kw * c, o)
        acc, scale, zp = q_matmul(patches.reshape(bsz * oh * ow, kkc),
                                  x.scale, x.zero_point,
                                  w2d, w.scale, w.zero_point,
                                  bit_width=bit_width)
        acc = acc.reshape(bsz, oh, ow, o)
    else:
        # patches are (KH, KW, C)-ordered: split C per group
        m = bsz * oh * ow
        pg = patches.reshape(m, kh * kw, g, cg).permute(2, 0, 1, 3) \
            .reshape(g, m, kh * kw * cg)
        # w [O, C/G, KH, KW] -> [G, KH*KW*C/G, O/G]
        wg = w.data.reshape(g, o // g, cg, kh, kw).permute(0, 3, 4, 2, 1) \
            .reshape(g, kh * kw * cg, o // g)
        w_scale = np.asarray(w.scale, np.float32)
        if w_scale.ndim > 0:  # per-channel scales follow the group split
            w_scale = w_scale.reshape(g, 1, o // g)
        acc, scale, zp = q_matmul(pg, x.scale, x.zero_point,
                                  wg, w_scale, w.zero_point,
                                  bit_width=bit_width)
        # [G, M, O/G] -> [B, OH, OW, O]
        acc = acc.permute(1, 0, 2).reshape(bsz, oh, ow, o)
        if zp is not None:
            zp = torch.broadcast_to(zp, (g, m, o // g)).permute(1, 0, 2) \
                .reshape(bsz, oh, ow, o)
        if np.asarray(scale, np.float32).ndim > 0:
            # (G, 1, O/G) group-major IS the natural O order
            scale = np.asarray(scale, np.float32).reshape(o)
    acc = acc.permute(0, 3, 1, 2)  # NCHW
    if zp is not None:
        if zp.ndim == 4:  # grouped: already [B, OH, OW, O]
            zp = zp.permute(0, 3, 1, 2)
        elif zp.shape[-2] == 1:
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
