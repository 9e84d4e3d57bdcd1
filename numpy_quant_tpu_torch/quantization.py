"""Quantization math core (PyTorch).

Port of ``numpy_quant_tpu/quantization.py`` in its TPU-mode numerics
(x64 off): int32 containers, float32 scale math, int8 x int8 -> int32
products. The reference's quirks carry over unchanged:

* signed integer range [-2^(b-1), 2^(b-1)-1];
* rounding is round-half-to-even everywhere (``torch.round`` is, like
  ``jnp.rint``);
* quantize clips BEFORE rounding; requantize rounds BEFORE clipping;
* quantize DIVIDES by the scale, requantize multiplies by ``1/scale``;
* q_matmul's zero-point correction is a tensor of row/column sums.

Scale divisors are 0-d tensors on the operand's device: PyTorch's CUDA
``tensor / python_scalar`` multiplies by the reciprocal, which is not
the IEEE quotient the JAX package computes.
"""
from __future__ import annotations

import numpy as np
import torch

# _int_mm's CUDA limits: more than 16 rows, K and N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def qrange(bit_width: int) -> tuple[float, float]:
    return -2.0 ** (bit_width - 1), 2.0 ** (bit_width - 1) - 1.0


def quant_parameters(min_val, max_val, bit_width: int, asymmetric: bool):
    """Scale/zero-point from calibration stats: host numpy float32
    arithmetic, the same code as the JAX package."""
    min_qval, max_qval = qrange(bit_width)
    min_val = np.float32(min_val)
    max_val = np.float32(max_val)

    if asymmetric:
        # constant-valued tensors yield scale == 0; those qparams are
        # never used
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = (max_val - min_val) / np.float32(max_qval - min_qval)
            zero_point0 = min_qval - min_val / scale
            zero_point = np.rint(np.nan_to_num(zero_point0)).astype(np.int64)
    else:
        scale = (np.float32(2.0) * max(max_val, min_val)) / np.float32(max_qval - min_qval)
        zero_point = None

    scale = np.array(scale, dtype=np.float32)
    return scale, zero_point


def per_channel_scales(data, bit_width: int, axis: int) -> np.ndarray:
    """Symmetric per-channel scales over ``axis`` (a weight's output
    channels), keeping the reduced axes: the abs-max formula of the JAX
    package (not the reference's positive-max quirk, which would give an
    all-negative channel scale 0)."""
    min_qval, max_qval = qrange(bit_width)
    arr = np.asarray(data, dtype=np.float32)
    reduce_axes = tuple(i for i in range(arr.ndim) if i != axis)
    absmax = np.abs(arr).max(axis=reduce_axes, keepdims=True)
    absmax = np.maximum(absmax, np.float32(1e-12))
    scale = (np.float32(2.0) * absmax) / np.float32(max_qval - min_qval)
    return scale.astype(np.float32)


def as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """A host scalar/array (or tensor) as a tensor of ``dtype`` on
    ``device`` -- the form a divisor must take to divide exactly."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    arr = np.asarray(x)
    if arr.ndim == 0:
        value = float(arr) if dtype.is_floating_point else int(arr)
        return torch.full((), value, dtype=dtype, device=device)
    host = torch.from_numpy(np.ascontiguousarray(
        arr.astype(np.float32 if dtype.is_floating_point else np.int64)))
    if torch.device(device).type == "cuda":
        # a pageable copy would wait for the stream to drain; a pinned
        # one is enqueued like a kernel (per-channel scale rows)
        return host.pin_memory().to(device, non_blocking=True).to(dtype)
    return host.to(device=device, dtype=dtype)


def quantize(data: torch.Tensor, bit_width: int, scale, zero_point) -> torch.Tensor:
    """float tensor -> int32 container tensor (divide, +zp, clip, rint)."""
    q = data.to(torch.float32) / as_tensor(scale, data.device)
    if zero_point is not None:
        q = as_tensor(zero_point, data.device) + q
    if np.any(np.asarray(scale) == 0):
        # a constant-valued tensor's zero scale gives 0/0: XLA's
        # float->int conversion maps that NaN to 0, torch's does not
        q = torch.nan_to_num(q, nan=0.0)
    min_qval, max_qval = qrange(bit_width)
    q = torch.clamp(q, min_qval, max_qval)
    return torch.round(q).to(torch.int32)


def dequantize(arr: torch.Tensor, scale, zero_point) -> torch.Tensor:
    """Integer container tensor -> float32."""
    if arr.dtype != torch.int32:
        # narrow int8 storage widens before the zero-point subtract
        arr = arr.to(torch.int32)
    if zero_point is not None:
        arr = arr - as_tensor(zero_point, arr.device, torch.int32)
    return arr.to(torch.float32) * as_tensor(scale, arr.device)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, extra]
    return torch.nn.functional.pad(t, pad)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer tensors holding int8 values.

    A 2-D rhs runs as ONE ``torch._int_mm`` over the flattened lhs rows.
    On CUDA the operands are zero-padded to _int_mm's limits (exact:
    zero rows and columns add nothing) and the result is sliced back.
    A batched rhs (the unfused attention's score/context products) runs
    as a float64 product, exact for int8 operands at any K below 2^38.
    """
    if b.ndim == 2:
        lead = a.shape[:-1]
        k, n = b.shape
        a2 = a.reshape(-1, k).to(torch.int8)
        b2 = b.to(torch.int8)
        m = a2.shape[0]
        if a2.is_cuda:
            kp = -(-k // _INT_MM_ALIGN) * _INT_MM_ALIGN
            np_ = -(-n // _INT_MM_ALIGN) * _INT_MM_ALIGN
            a2 = _pad_to(_pad_to(a2, 1, kp), 0, max(m, _INT_MM_MIN_ROWS))
            b2 = _pad_to(_pad_to(b2, 0, kp), 1, np_)
        y = torch._int_mm(a2.contiguous(), b2.contiguous())[:m, :n]
        return y.reshape(*lead, n)
    y = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return y.to(torch.int32)


def q_matmul(arr_a, scale_a, zero_point_a, arr_b, scale_b, zero_point_b,
             bit_width: int = 8, b_colsum=None):
    """Integer matmul with tensor zero-point correction.

    Returns (acc, scale, zero_point) with real = (acc - zero_point) *
    scale; zero_point is None or an int32 correction tensor.
    ``b_colsum``: precomputed column sums of arr_b (weight constants).
    """
    if bit_width > 8:
        raise NotImplementedError(
            f"{bit_width}-bit matmuls are not ported (int8 only)")
    k = arr_a.shape[-1]
    acc = int_matmul(arr_a, arr_b)
    scale = (np.asarray(scale_a, np.float32) * np.asarray(scale_b, np.float32))
    if scale.ndim == 0:
        scale = np.float32(scale)
    if zero_point_a is None and zero_point_b is None:
        return acc, scale, None
    i32 = torch.int32
    dev = acc.device
    if zero_point_a is not None and b_colsum is None:
        b_colsum = arr_b.to(i32).sum(dim=-2, keepdim=True, dtype=i32)
    if zero_point_a is None:
        a_rowsum = arr_a.to(i32).sum(dim=-1, keepdim=True, dtype=i32)
        zero_point = a_rowsum * as_tensor(zero_point_b, dev, i32)
    elif zero_point_b is None:
        zero_point = b_colsum.to(i32) * as_tensor(zero_point_a, dev, i32)
    else:
        a_rowsum = arr_a.to(i32).sum(dim=-1, keepdim=True, dtype=i32)
        zpa = as_tensor(zero_point_a, dev, i32)
        zpb = as_tensor(zero_point_b, dev, i32)
        zero_point = a_rowsum * zpb + b_colsum.to(i32) * zpa - zpa * zpb * k
    return acc, scale, zero_point


def requantize(arr, arr_scale, arr_zero_points, res_scale, res_zero_point,
               bit_width: int) -> torch.Tensor:
    """Requantize to new (scale, zero_point, bit_width) via the float
    path: multiply by 1/res_scale, +zp, rint, then clip."""
    min_qval, max_qval = qrange(bit_width)
    dequant = dequantize(arr, arr_scale, arr_zero_points)
    inv_scale = np.float32(1.0) / np.asarray(res_scale, np.float32)
    scaled = as_tensor(inv_scale, dequant.device) * dequant
    if res_zero_point is not None:
        scaled = as_tensor(res_zero_point, dequant.device) + scaled
    q = torch.clamp(torch.round(scaled), min_qval, max_qval)
    return q.to(torch.int32)
