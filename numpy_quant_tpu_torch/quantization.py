"""Quantization math core (PyTorch).

Port of ``numpy_quant_tpu/quantization.py``. Up to 8 bits it follows the
JAX package's TPU-mode numerics (x64 off): int32 containers, float32
scale math, int8 x int8 -> int32 products. Above 8 bits it follows its
x64 mode, the only one in which JAX computes 9-16-bit matmuls exactly:
int64 containers, the zero point added in float64, dequantize products
taken in float64 and rounded once to float32, exact int64 accumulators.
The container carries the mode: int64 data is x64-mode data. The
reference's quirks carry over unchanged:

* signed integer range [-2^(b-1), 2^(b-1)-1];
* rounding is round-half-to-even everywhere (``torch.round`` is, like
  ``jnp.rint``);
* quantize clips BEFORE rounding; requantize rounds BEFORE clipping;
* quantize DIVIDES by the scale, requantize multiplies by ``1/scale``;
* q_matmul's zero-point correction is a tensor of row/column sums.

``quantize`` and ``dequantize`` run the elementwise kernels of
``kernels/elementwise.py`` (their plain versions on CPU tensors). Scale
divisors of the remaining torch arithmetic are 0-d tensors on the
operand's device: PyTorch's CUDA ``tensor / python_scalar`` multiplies by
the reciprocal, which is not the IEEE quotient the JAX package computes.
"""
from __future__ import annotations

import numpy as np
import torch

from .intops import as_tensor, int_matmul, qrange
from .kernels import elementwise as _elementwise


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


def weight_only_scales(arr: np.ndarray, bit_width: int, ch_axis: int,
                       per_channel: bool = True, group_size: int = None,
                       groupable: bool = False):
    """The symmetric scale choice of Model.quantize_weights for a 2-D
    weight (host numpy, the JAX package's code). Returns (full_scale,
    store_scale): ``full_scale`` broadcasts against ``arr``;
    ``store_scale`` is the compact grouped [K/g, N] array when the
    grouped path applies, else None. ``groupable`` is the caller's
    consumer-based decision (all-MatMul rhs with ch_axis == 1)."""
    min_q, max_q = qrange(bit_width)
    if groupable and group_size and arr.shape[0] % int(group_size) == 0:
        g = int(group_size)
        grp = arr.reshape(arr.shape[0] // g, g, arr.shape[1])
        absmax = np.maximum(np.abs(grp).max(axis=1), np.float32(1e-12))
        store_scale = (np.float32(2.0) * absmax
                       / np.float32(max_q - min_q)).astype(np.float32)
        return np.repeat(store_scale, g, axis=0), store_scale
    if per_channel:
        return per_channel_scales(arr, bit_width, ch_axis), None
    absmax = max(float(np.abs(arr).max()), 1e-12)
    return np.float32(2.0 * absmax / (max_q - min_q)), None


def percentile_range(x: torch.Tensor, percentile: float) -> torch.Tensor:
    """[lo, hi] on ``x``'s device: the (100 - p)th and pth percentiles of
    its elements as the JAX package's ``jnp.quantile`` computes them --
    linear interpolation between the sorted neighbours of the position
    ``q * (n - 1)``, with q, n, the position and both weights in float32,
    the sum of the two weighted neighbours as one fused multiply-add --
    from one sort (``torch.quantile`` refuses inputs above 2^24
    elements)."""
    flat = torch.sort(x.reshape(-1).to(torch.float32)).values
    n = np.float32(flat.numel())
    last = np.float32(n - np.float32(1.0))
    out = []
    for q in (np.float32(1.0 - percentile / 100.0),
              np.float32(percentile / 100.0)):
        pos = np.float32(q * last)
        low, high = np.floor(pos), np.ceil(pos)
        w_high = np.float32(pos - low)
        w_low = np.float32(np.float32(1.0) - w_high)
        # clamped as JAX clamps: in float32, then its gather's own clamp
        ends = [min(int(np.clip(i, np.float32(0.0), last)), flat.numel() - 1)
                for i in (low, high)]
        # low * w_low + high * w_high as XLA contracts it: one fused
        # multiply-add over the rounded first product (float64 holds the
        # exact product; one rounding to float32)
        first = (flat[ends[0]] * float(w_low)).to(torch.float64)
        out.append((flat[ends[1]].to(torch.float64) * float(w_high)
                    + first).to(torch.float32))
    return torch.stack(out)


def container_dtype(bit_width: int) -> torch.dtype:
    """The integer container of ``bit_width``-bit values: int32 (TPU-mode
    numerics) up to 8 bits, int64 (x64 mode) above."""
    return torch.int32 if bit_width <= 8 else torch.int64


def quantize(data: torch.Tensor, bit_width: int, scale, zero_point,
             container: torch.dtype = None) -> torch.Tensor:
    """float tensor -> integer container tensor (divide, +zp, clip, rint).
    ``container`` (default ``container_dtype(bit_width)``): int32 computes
    in float32, int64 adds the zero point in float64 (x64 mode)."""
    return _elementwise.quantize(
        data, bit_width, scale, zero_point,
        out_dtype=container or container_dtype(bit_width))


def dequantize(arr: torch.Tensor, scale, zero_point,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Integer container tensor -> float (``dtype``: float32, or bfloat16
    rounded from the float32 value). int64 containers multiply in
    float64."""
    return _elementwise.dequantize(arr, scale, zero_point, out_dtype=dtype)


def fake_quantize(data: torch.Tensor, bit_width: int, scale, zero_point,
                  container: torch.dtype = None) -> torch.Tensor:
    """float tensor -> float32 ``dequantize(quantize(data, ...,
    container), scale, zero_point)`` in one pass (one kernel launch on
    the card)."""
    return _elementwise.fake_quantize(
        data, bit_width, scale, zero_point,
        container=container or container_dtype(bit_width))


def wide_matmul(a: torch.Tensor, b: torch.Tensor,
                bit_width: int) -> torch.Tensor:
    """Exact int64 product of integer tensors holding values of at most
    ``bit_width`` bits: x64 mode's int64 dot. On the CPU an int64
    product; on CUDA (no int64 GEMM, and ``_int_mm`` takes int8 only) a
    float64 product, exact while every partial sum stays below 2^53,
    i.e. K * 2^(2b-2) < 2^53 (K < 2^23 at 16 bits)."""
    if a.is_cuda:
        k = a.shape[-1]
        if k * 2.0 ** (2 * bit_width - 2) >= 2.0 ** 53:
            raise ValueError(f"K={k} at {bit_width} bits leaves float64's "
                             "exact integer range")
        y = torch.matmul(a.to(torch.float64), b.to(torch.float64))
        return y.to(torch.int64)
    return torch.matmul(a.to(torch.int64), b.to(torch.int64))


def q_matmul(arr_a, scale_a, zero_point_a, arr_b, scale_b, zero_point_b,
             bit_width: int = 8, b_colsum=None):
    """Integer matmul with tensor zero-point correction.

    Returns (acc, scale, zero_point) with real = (acc - zero_point) *
    scale; zero_point is None or a correction tensor. With an int64
    operand (x64 mode) acc and corrections are int64 and the product is
    ``wide_matmul``'s; else they are int32 and the product is
    ``int_matmul``'s, which takes at most 8-bit values.
    ``b_colsum``: precomputed column sums of arr_b (weight constants).
    """
    wide = arr_a.dtype == torch.int64 or arr_b.dtype == torch.int64
    if not wide and bit_width > 8:
        raise ValueError(f"{bit_width}-bit operands need an int64 "
                         "container (x64 mode)")
    k = arr_a.shape[-1]
    acc = wide_matmul(arr_a, arr_b, bit_width) if wide \
        else int_matmul(arr_a, arr_b)
    scale = (np.asarray(scale_a, np.float32) * np.asarray(scale_b, np.float32))
    if scale.ndim == 0:
        scale = np.float32(scale)
    if zero_point_a is None and zero_point_b is None:
        return acc, scale, None
    idt = torch.int64 if wide else torch.int32
    dev = acc.device
    if zero_point_a is not None and b_colsum is None:
        b_colsum = arr_b.to(idt).sum(dim=-2, keepdim=True, dtype=idt)
    if zero_point_a is None:
        a_rowsum = arr_a.to(idt).sum(dim=-1, keepdim=True, dtype=idt)
        zero_point = a_rowsum * as_tensor(zero_point_b, dev, idt)
    elif zero_point_b is None:
        zero_point = b_colsum.to(idt) * as_tensor(zero_point_a, dev, idt)
    else:
        a_rowsum = arr_a.to(idt).sum(dim=-1, keepdim=True, dtype=idt)
        zpa = as_tensor(zero_point_a, dev, idt)
        zpb = as_tensor(zero_point_b, dev, idt)
        zero_point = a_rowsum * zpb + b_colsum.to(idt) * zpa - zpa * zpb * k
    return acc, scale, zero_point


def requantize(arr, arr_scale, arr_zero_points, res_scale, res_zero_point,
               bit_width: int) -> torch.Tensor:
    """Requantize to new (scale, zero_point, bit_width) via the float
    path: multiply by 1/res_scale, +zp, rint, then clip. The result is
    int64 (x64 mode: the zero point added in float64) for an int64 input,
    else int32."""
    wide = arr.dtype == torch.int64
    min_qval, max_qval = qrange(bit_width)
    dequant = dequantize(arr, arr_scale, arr_zero_points)
    inv_scale = np.float32(1.0) / np.asarray(res_scale, np.float32)
    scaled = as_tensor(inv_scale, dequant.device) * dequant
    if res_zero_point is not None:
        if wide:
            scaled = as_tensor(res_zero_point, dequant.device,
                               torch.float64) + scaled.to(torch.float64)
        else:
            scaled = as_tensor(res_zero_point, dequant.device) + scaled
    q = torch.clamp(torch.round(scaled), min_qval, max_qval)
    return q.to(torch.int64 if wide else torch.int32)

