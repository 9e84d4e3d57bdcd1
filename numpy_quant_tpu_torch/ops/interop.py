"""ONNX interop ops: the standard quantized formats other tools emit, run
on the tensor layer (port of the QDQ, QOperator, dynamic-quantization,
Cast and ConstantOfShape branches of ``numpy_quant_tpu/ops/registry.py``).

* ``QuantizeLinear`` / ``DequantizeLinear`` take ONNX semantics, not the
  reference's: ``rint(x / s)``, then ``+ zp``, then a clip to the storage
  dtype's range (uint8 without a zero point), with per-axis scales and
  zero points along ``axis``. Storage wider than 8 bits is refused. A
  uint8 QTensor counts one more signed-range bit than its storage (9 for
  [0, 255]), so requantize clips and matmul carriers stay right.
* ``QLinearMatMul`` / ``QLinearConv`` run integer-exact through
  ``q_matmul`` / ``qconv2d`` and one output requantize. Their scale
  initializers are read on the host (each small float constant keeps a
  host copy, ``graph.wrap_array``). uint8 operands shift to int8 storage
  with the zero point shifted alike (the same integers ``(q - zp)``), so
  every product is an int8 one.
* ``DynamicQuantizeLinear`` + ``MatMulInteger`` (+ ``Cast``): onnxruntime's
  ``quantize_dynamic`` pattern; ``DynamicMatMul``: the JAX package's fused
  dynamic op (per-row or per-tensor activation params).

``DequantizeLinear`` runs ``quantization.dequantize`` (the elementwise
kernel on a CUDA tensor): the same ``float(q - zp) * s`` in float32. The
quantize order here (zero point after ``rint``, unsigned clip) is not the
kernel's, so ``QuantizeLinear`` stays torch ops, as JAX's stays ``jnp``.
Divisors are 0-d tensors: CUDA's ``tensor / python_scalar`` multiplies by
the reciprocal.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import config
from ..intops import as_tensor, int_matmul, place, qrange
from ..quantization import dequantize
from ..tensor import DITensor, FTensor, ITensor, QTensor, qconv2d

# the device of the model whose graph is being walked (Model._forward):
# ops whose inputs are all host values (ConstantOfShape, a Cast of a shape
# tensor) make their float outputs there
_EXEC_DEVICE = torch.device("cpu")


def exec_device() -> torch.device:
    """The device of the graph being walked (``executing_on``)."""
    return _EXEC_DEVICE


@contextlib.contextmanager
def executing_on(device):
    global _EXEC_DEVICE
    prev, _EXEC_DEVICE = _EXEC_DEVICE, torch.device(device)
    try:
        yield
    finally:
        _EXEC_DEVICE = prev


def _device_ints(t) -> torch.Tensor:
    """An integer payload on the device: a QTensor's data, an ITensor's
    placed copy, or a float-valued FTensor's values as int32."""
    if isinstance(t, ITensor):
        return t.on(_EXEC_DEVICE)
    if isinstance(t, FTensor):
        return t.data.to(torch.int32)
    return t.data


def _host_scale(t) -> np.ndarray:
    """A scale read on the host, as JAX's ``_host_scale``: the host copy of
    a small float constant (no device read in the walk)."""
    host = getattr(t, "host", None)
    if host is None:
        raise ValueError("QLinear scales must be float initializers or "
                         "Constant nodes (read on the host)")
    return np.asarray(host, np.float32)


def _axis_shape(rank: int, axis: int) -> list:
    shape = [1] * rank
    shape[axis % rank] = -1
    return shape


def _linear_params(inputs, attrs, rank):
    """(scale as the node computes with it, scale for the QTensor, zero
    point on the device or None, host zero point or None), scale and zero
    point shaped to broadcast along ``axis``."""
    scale = inputs[1]
    zp = inputs[2] if len(inputs) > 2 else None
    sdata = scale.data
    per_axis = sdata.numel() > 1
    bshape = _axis_shape(rank, int(attrs.get("axis", 1)))
    if per_axis:
        sdata = sdata.reshape(bshape)
    host = getattr(scale, "host", None)
    qscale = sdata if host is None else (
        np.asarray(host, np.float32).reshape(bshape) if per_axis
        else np.float32(np.asarray(host).reshape(-1)[0]))
    zdev = zhost = None
    if zp is not None:
        zhost = np.asarray(zp.data, np.int64)
        if zhost.size > 1:
            zhost = zhost.reshape(bshape)
            zdev = _device_ints(zp).reshape(bshape)
        else:
            zhost = zhost.reshape(())
    return sdata, qscale, zdev, zhost


def _storage_bits(dtype) -> tuple[int, np.iinfo]:
    """Signed-range bits of a storage dtype (one more for unsigned, so
    [0, 2^b - 1] fits [-2^b, 2^b - 1]) and its range; refuses > 8 bits."""
    info = np.iinfo(dtype)
    if info.bits > 8:
        raise ValueError(f"storage dtype {np.dtype(dtype)} not supported "
                         "(int8/uint8 only)")
    return int(info.bits) + (1 if info.min == 0 else 0), info


def quantize_linear(inputs, attrs) -> list:
    x, zp = inputs[0], inputs[2] if len(inputs) > 2 else None
    xd = x.data
    sdata, qscale, zdev, zhost = _linear_params(inputs, attrs, xd.ndim)
    bits, info, dtype = _storage(zp, None)
    q = torch.round(xd.to(torch.float32) / sdata.to(torch.float32))
    if zhost is not None:
        zf = zdev.to(torch.float32) if zdev is not None \
            else as_tensor(zhost, q.device)
        q = q + zf
    q = torch.clamp(q, info.min, info.max).to(torch.int32)
    return [QTensor(q, bits, qscale, zhost, orig_dtype=dtype)]


def dequantize_linear(inputs, attrs) -> list:
    """y = float(x - zp) * s with THIS node's scale and zero point."""
    xd = _device_ints(inputs[0])
    sdata, qscale, zdev, zhost = _linear_params(inputs, attrs, xd.ndim)
    if isinstance(qscale, np.ndarray) and qscale.ndim > 0 \
            or isinstance(qscale, torch.Tensor):
        # per-axis, or computed in the graph: the device values, as the
        # data plane holds them (bf16 in the serving mode)
        scale = sdata.to(torch.float32)
    else:
        # by value, rounded through the data plane's dtype like the
        # constant's device copy
        scale = np.float32(torch.tensor(float(qscale))
                           .to(config.float_dtype).item())
    zero_point = zdev.to(torch.int32) if zdev is not None else (
        None if zhost is None else int(zhost))
    return [FTensor(dequantize(xd, scale, zero_point,
                               dtype=config.float_dtype))]


def _storage(zp_t, payload_t):
    """Storage dtype from the zero point (or payload) tensor."""
    dtype = getattr(zp_t, "orig_dtype", None) if zp_t is not None else None
    if dtype is None:
        dtype = getattr(payload_t, "orig_dtype", None) or np.dtype(np.uint8)
    bits, info = _storage_bits(dtype)
    return bits, info, np.dtype(dtype)


def _qlinear_operand(op, t, st, zt, per_channel=False) -> QTensor:
    """A QLinear input as an int8-storage QTensor: uint8 values and their
    zero point shift by -128 (the same ``q - zp`` integers)."""
    sdata = _host_scale(st)
    if sdata.size != 1 and not per_channel:
        raise ValueError(f"{op}: per-axis operand scales are only "
                         "supported for QLinearConv weights")
    _, info, _ = _storage(zt, t)
    zp = 0
    if zt is not None:
        z = np.asarray(zt.data).reshape(-1)
        if z.size != 1:
            # the common per-channel form carries an all-zero zp vector
            # beside the per-channel scales
            if np.any(z != 0):
                raise ValueError(f"{op}: per-axis zero points are not "
                                 "supported")
        else:
            zp = int(z[0])
    data = _device_ints(t)
    if info.min == 0:
        data, zp = data.to(torch.int32) - 128, zp - 128
    scale = np.float32(sdata.reshape(-1)[0]) if sdata.size == 1 \
        else sdata.reshape(-1)
    return QTensor(data, 8, scale, np.int64(zp) if zp else None)


def qlinear(op: str, inputs, attrs) -> list:
    """QLinearMatMul / QLinearConv: the integer product, then
    y = clip(rint(acc_real / s_y) + zp_y) to the output storage range."""
    a, a_s, a_z = inputs[0], inputs[1], inputs[2]
    b, b_s, b_z = inputs[3], inputs[4], inputs[5]
    y_s = inputs[6]
    y_z = inputs[7] if len(inputs) > 7 else None
    bias = inputs[8] if len(inputs) > 8 else None
    qa = _qlinear_operand(op, a, a_s, a_z)
    qb = _qlinear_operand(op, b, b_s, b_z, per_channel=op == "QLinearConv")
    if op == "QLinearConv":
        qbias = None
        if bias is not None:
            # int32 bias at scale s_x * s_w, zero point 0 (ONNX spec)
            qbias = QTensor(_device_ints(bias).to(torch.int32), 32,
                            np.float32(qa.scale)
                            * np.asarray(qb.scale, np.float32), None)
        acc = qconv2d(qa, qb, qbias,
                      tuple(attrs.get("pads", (0, 0, 0, 0))),
                      tuple(attrs.get("strides", (1, 1))),
                      tuple(attrs.get("dilations", (1, 1))),
                      int(attrs.get("group", 1)))
    else:
        acc = qa.matmul(qb)
    bits_y, info_y, dtype_y = _storage(y_z, None)
    ys = np.float32(_host_scale(y_s).reshape(-1)[0])
    real = acc.dequantize().data.to(torch.float32)
    q = torch.round(real / as_tensor(ys, real.device))
    zy = None
    if y_z is not None:
        z = int(np.asarray(y_z.data).reshape(-1)[0])
        if z:
            q = q + as_tensor(z, real.device)
            zy = np.int64(z)
    q = torch.clamp(q, info_y.min, info_y.max).to(torch.int32)
    return [QTensor(q, bits_y, ys, zy, orig_dtype=dtype_y)]


def dynamic_quantize_linear(inputs, attrs) -> list:
    """ONNX opset-11 dynamic quantization: uint8 asymmetric params from
    this tensor's min/max. The outputs ride as float-valued FTensors (y in
    [0, 255] is exact in float); MatMulInteger re-enters the integers."""
    x = inputs[0].data.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    mn = torch.minimum(x.min(), zero)
    mx = torch.maximum(x.max(), zero)
    scale = (mx - mn) / as_tensor(255.0, x.device)
    scale = torch.where(scale > 0, scale, one)
    zp = torch.clamp(torch.round(-mn / scale), 0.0, 255.0)
    y = torch.clamp(torch.round(x / scale) + zp, 0.0, 255.0)
    return [FTensor(y), FTensor(scale.reshape(())), FTensor(zp.reshape(()))]


def matmul_integer(inputs, attrs) -> list:
    """ONNX opset-10 integer matmul with zero-point subtraction, exact
    int32 accumulation (a float64 product: exact for these magnitudes);
    the float cast happens at the consumer Cast."""
    def as_int(i):
        if len(inputs) <= i or inputs[i] is None:
            return None
        return _device_ints(inputs[i]).to(torch.int32)

    a, b = as_int(0), as_int(1)
    azp, bzp = as_int(2), as_int(3)
    if azp is not None:
        a = a - azp
    if bzp is not None:
        b = b - bzp
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return [FTensor(acc.to(torch.int32).to(torch.float32))]


def dynamic_matmul(inputs, attrs) -> list:
    """The JAX package's dynamic-quantization MatMul: the float input
    quantizes with scales from this batch (per row or per tensor), an int8
    product against the symmetric weight, the zero-point-corrected
    dequantize; no calibration constant anywhere."""
    x, w = inputs[0], inputs[1]
    bw = int(attrs["bit_width"])
    if max(bw, w.bit_width) > 8:
        raise ValueError("DynamicMatMul takes at most 8-bit operands")
    lo, hi = qrange(bw)
    xd = x.data.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=xd.device)
    if attrs.get("granularity", "row") == "row":
        mn = torch.minimum(torch.amin(xd, dim=-1, keepdim=True), zero)
        mx = torch.maximum(torch.amax(xd, dim=-1, keepdim=True), zero)
    else:
        mn = torch.minimum(xd.min(), zero)
        mx = torch.maximum(xd.max(), zero)
    scale = (mx - mn) / as_tensor(hi - lo, xd.device)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    zp = torch.round(as_tensor(lo, xd.device) - mn / scale)
    xq = torch.round(torch.clamp(xd / scale + zp, lo, hi))
    acc = int_matmul(xq.to(torch.int32), w.data)
    colsum = w.colsum
    if colsum is None:
        colsum = w.data.to(torch.int32).sum(dim=-2, keepdim=True,
                                            dtype=torch.int32)
    corr = zp.to(torch.int32) * colsum.to(torch.int32)
    y = (acc - corr).to(torch.float32) \
        * (scale * as_tensor(w.scale, xd.device))
    return [FTensor(y)]


def _to_float(x) -> FTensor:
    if isinstance(x, FTensor):
        return x.copy()
    if isinstance(x, ITensor):
        return FTensor(place(x.data, _EXEC_DEVICE, torch.float32))
    return FTensor(x.data.to(torch.float32))


def cast(inputs, attrs) -> list:
    x, to = inputs[0], int(attrs["to"])
    if to == 1:  # FLOAT
        return [_to_float(x)]
    if to in (6, 7):  # INT32 / INT64
        if isinstance(x, (ITensor, DITensor)):
            return [x.copy()]
        raise ValueError("Cast of device float data to int is not "
                         "supported (shape domain only)")
    raise ValueError(f"Cast to elem_type {to} not supported")


def cast_like(inputs, attrs) -> list:
    x, like = inputs[0], inputs[1]
    if isinstance(like, FTensor):
        return [_to_float(x)]
    if isinstance(like, (ITensor, DITensor)) \
            and isinstance(x, (ITensor, DITensor)):
        return [x.copy()]
    raise ValueError("CastLike of device float data to int is not "
                     "supported (shape domain only)")


def constant_of_shape(inputs, attrs) -> list:
    shape = tuple(int(d) for d in inputs[0].data)
    value = attrs.get("value")
    value = np.zeros(1, np.float32) if value is None else np.asarray(value)
    fill = value.reshape(-1)[0]
    if value.dtype == np.float32:
        return [FTensor(torch.full(shape, float(fill), dtype=torch.float32,
                                   device=_EXEC_DEVICE))]
    if value.dtype == np.int64:
        return [ITensor(np.full(shape, fill, dtype=np.int64))]
    raise ValueError(f"ConstantOfShape dtype {value.dtype} not supported.")


OPS = {
    "QuantizeLinear": quantize_linear,
    "DequantizeLinear": dequantize_linear,
    "QLinearMatMul": lambda i, a: qlinear("QLinearMatMul", i, a),
    "QLinearConv": lambda i, a: qlinear("QLinearConv", i, a),
    "DynamicQuantizeLinear": dynamic_quantize_linear,
    "MatMulInteger": matmul_integer,
    "DynamicMatMul": dynamic_matmul,
    "Cast": cast,
    "CastLike": cast_like,
    "ConstantOfShape": constant_of_shape,
}
