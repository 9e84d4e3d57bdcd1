"""Integer helpers below both the quantization math (``quantization.py``)
and the kernels' plain versions (``kernels/``): the signed clip range of a
bit width, host values as device tensors (each host array placed once),
and the exact int8 product. Imports nothing of the package."""
from __future__ import annotations

import numpy as np
import torch

# _int_mm's CUDA limits: more than 16 rows, K and N multiples of 8; and
# cuBLASLt's int8 kernels refuse (CUBLAS_STATUS_NOT_SUPPORTED) a product
# with K below 128 and N from 32 on unless M is a multiple of 32 (swept on
# an H100 80GB HBM3: chip_smoke.py's check_int_matmul)
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8
_INT_MM_SHORT_K, _INT_MM_WIDE_N, _INT_MM_ROW_ALIGN = 128, 32, 32


def qrange(bit_width: int) -> tuple[float, float]:
    return -2.0 ** (bit_width - 1), 2.0 ** (bit_width - 1) - 1.0


def as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """A host scalar/array (or tensor) as a tensor of ``dtype`` on
    ``device`` -- the form a divisor must take to divide exactly. A
    scalar is a fill; an array is :func:`place`'s copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    arr = np.asarray(x)
    if arr.ndim == 0:
        value = float(arr) if dtype.is_floating_point else int(arr)
        return torch.full((), value, dtype=dtype, device=device)
    return place(arr, device, dtype)


# host arrays already on a device, by (device, dtype, shape, bytes)
_placed: dict = {}
# host arrays copied to a device so far (each distinct one once)
placements = 0


def place(arr, device, dtype) -> torch.Tensor:
    """A host array (per-channel scale rows, zero points, Gather indices,
    Where conditions) as a tensor of ``dtype`` on ``device``: copied once
    per distinct content and kept, so a forward's later walks, and the
    CUDA graph captured from one (model.py), read the same placed tensor
    and copy nothing from the host. The values pass through float32 (a
    float ``dtype``), bool or int64 on the host, as before placement.
    Raises during a CUDA graph capture: a copy made then would replay
    from a host buffer that is gone."""
    global placements
    host_dtype = np.float32 if dtype.is_floating_point \
        else np.bool_ if dtype == torch.bool else np.int64
    arr = np.ascontiguousarray(np.asarray(arr).astype(host_dtype, copy=False))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, dtype, arr.shape, arr.tobytes())
    t = _placed.get(key)
    if t is not None:
        if t.is_inference() and torch.is_grad_enabled():
            # a walk autograd tracks (qat.py) cannot save a tensor made
            # under inference mode for backward: it reads a copy
            return t.clone()
        return t
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"a host array {arr.shape} reached the device during a CUDA "
            "graph capture; the warm-up walk before it places every one")
    host = torch.from_numpy(arr.copy())
    if device.type == "cuda":
        # a pageable copy would wait for the stream to drain; a pinned
        # one is enqueued like a kernel
        host = host.pin_memory().to(device, non_blocking=True)
    t = host.to(device=device, dtype=dtype)
    _placed[key] = t
    placements += 1
    return t


# XLA's CPU compiler rewrites a reduce longer than this into windows of it
_XLA_CPU_WINDOW = 32


def _chain(x: torch.Tensor) -> torch.Tensor:
    """The last axis of ``x`` (not empty) summed left to right from 0."""
    acc = x[..., 0] + 0.0  # 0 + x0: -0.0 becomes +0.0, as XLA's does
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def xla_cpu_row_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of ``x`` over ``dim`` in the order XLA's CPU compiler emits for
    a float row reduce, bit for bit (``jnp.sum``, eager or jitted; ``dim``
    dropped). A row of n > 32 is padded with zeros to a multiple of 32,
    (32·⌈n/32⌉ − n) // 2 of them in front and the rest behind, each window
    of 32 is chained from 0 and the ⌈n/32⌉ partials are reduced by the same
    rule; a row of at most 32 is one chain from 0. At most 32 vector adds
    per level; ``x`` has at least one element along ``dim``."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    while n > _XLA_CPU_WINDOW:
        windows = -(-n // _XLA_CPU_WINDOW)
        pad = windows * _XLA_CPU_WINDOW - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _chain(x.reshape(*x.shape[:-1], windows, _XLA_CPU_WINDOW))
        n = windows
    return _chain(x)


_FUSED_CHECKED = []


def _check_fused() -> None:
    """Raise unless torch's CPU addcmul rounds a * b + c once in this
    build, on a vector body, its tail and a broadcast walk: (1 + 2^-23)^2
    - (1 + 2^-22) is 2^-46 fused and 0 with the product rounded first."""
    one = 1.0 + 2.0 ** -23
    for sa, sb, sc in (((67,), (67,), (67,)), ((67, 1), (1, 5), (67, 5))):
        got = torch.addcmul(torch.full(sc, -(1.0 + 2.0 ** -22)),
                            torch.full(sa, one), torch.full(sb, one))
        if not bool((got == 2.0 ** -46).all()):
            raise RuntimeError(
                "torch's CPU addcmul rounds the product before the sum in "
                "this build, so XLA's CPU float32 order (fused "
                "multiply-adds) cannot be replayed on the CPU")
    _FUSED_CHECKED.append(True)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round_f32(a * b + c) of float32 CPU tensors, one rounding (fused):
    torch's CPU addcmul, whose vector unit's fused multiply-add is checked
    on a probe at the first call (it raises where the build rounds twice;
    ``tests/test_torch_xla_order.py`` holds it to an exact replay)."""
    if not _FUSED_CHECKED:
        _check_fused()
    return torch.addcmul(c, a, b)


# XLA's CPU exp of float32 (jaxlib 0.9): Cephes' range reduction and
# polynomial in fused multiply-adds, 2^m with m at most 127, and results
# below the smallest normal flushed to 0 (XLA runs its CPU code with
# denormals off)
_EXP_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_F32_MIN_NORMAL = 2.0 ** -126
_EXP_FLUSHED = -88.0  # exp(x) < 2^-126 below: 0, whatever m's range


def xla_cpu_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor bit for bit as XLA's CPU compiler emits it
    (``jnp.exp``, eager or inside a fused program): m = floor(x log2(e) +
    1/2) capped at 127, r = x - m ln2 in two fused steps, e^r by a
    degree-7 polynomial in fused multiply-adds, times 2^m; below
    2^-126 the result is 0. Nine vectorized fused multiply-adds."""
    def c(v):
        return torch.full((), v, dtype=torch.float32)

    m = torch.floor(fma_f32(x, c(_EXP_LOG2E), c(0.5))).clamp(max=127.0)
    r = fma_f32(m, c(-_EXP_C1), x)
    r = fma_f32(m, c(-_EXP_C2), r)
    y = fma_f32(r, c(_EXP_POLY[0]), c(_EXP_POLY[1]))
    for p in _EXP_POLY[2:]:
        y = fma_f32(y, r, c(p))
    y = fma_f32(y, r * r, r) + 1.0
    # 2^m from its bits (m = -127 gives 0: every such result is flushed)
    pow2 = ((m.clamp(min=-127.0).to(torch.int32) + 127) << 23) \
        .view(torch.float32)
    out = y * pow2
    out = torch.where((out < _F32_MIN_NORMAL) | (x < _EXP_FLUSHED),
                      torch.zeros_like(out), out)
    return torch.where(x == float("inf"), x, out)


def replays_xla(*ts: torch.Tensor) -> bool:
    """Whether CPU float32 math on ``ts`` replays XLA's CPU order: float32
    CPU tensors outside an autograd walk (a walk that autograd tracks,
    QAT's and the trainers', keeps torch's ops, which it can
    differentiate)."""
    return all(t.device.type == "cpu" and t.dtype == torch.float32
               and not (t.requires_grad and torch.is_grad_enabled())
               for t in ts)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, extra]
    return torch.nn.functional.pad(t, pad)


def int_mm_shape(m: int, k: int, n: int) -> tuple[int, int, int]:
    """The zero-padded (M, K, N) at which ``int_matmul`` runs an [M, K] @
    [K, N] product on the card: K and N to multiples of 8, M to at least
    17 rows and, for K < 128 with N >= 32, to a multiple of 32."""
    kp = -(-k // _INT_MM_ALIGN) * _INT_MM_ALIGN
    np_ = -(-n // _INT_MM_ALIGN) * _INT_MM_ALIGN
    mp = max(m, _INT_MM_MIN_ROWS)
    if kp < _INT_MM_SHORT_K and np_ >= _INT_MM_WIDE_N:
        mp = -(-mp // _INT_MM_ROW_ALIGN) * _INT_MM_ROW_ALIGN
    return mp, kp, np_


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer tensors holding int8 values.

    A 2-D rhs runs as ONE ``torch._int_mm`` over the flattened lhs rows.
    On CUDA the operands are zero-padded to the shape :func:`int_mm_shape`
    gives (exact: zero rows and columns add nothing) and the result is
    sliced back.
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
            mp, kp, np_ = int_mm_shape(m, k, n)
            a2 = _pad_to(_pad_to(a2, 1, kp), 0, mp)
            b2 = _pad_to(_pad_to(b2, 0, kp), 1, np_)
        y = torch._int_mm(a2.contiguous(), b2.contiguous())[:m, :n]
        return y.reshape(*lead, n)
    y = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return y.to(torch.int32)
