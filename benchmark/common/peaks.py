"""Data-sheet peaks and the least time of a product.

The peaks are NVIDIA's dense figures (no sparsity) at the card's full
power limit; a result states the card's limit beside every share of them.
TF32 is off in the program, so a float32 product is held against the
float32 rate outside the tensor cores. The table and the bound arithmetic
are copied from the repository's chip_smoke.py and kernel_times.py so
that a change to the program cannot move them."""
from __future__ import annotations

PEAKS = {
    "H100 PCIe": dict(bytes=2.0e12, int8=1513e12, bf16=756e12, f32=51e12),
    "H100 NVL": dict(bytes=3.9e12, int8=1671e12, bf16=835e12, f32=60e12),
    "H100": dict(bytes=3.35e12, int8=1979e12, bf16=989e12, f32=67e12)}


def peaks(device_name: str) -> dict:
    """The peaks of the card named ``device_name``
    (``torch.cuda.get_device_name``)."""
    for key in ("H100 PCIe", "H100 NVL", "H100"):
        if key in device_name:
            return PEAKS[key]
    raise ValueError(f"no data-sheet peaks for {device_name!r}")


def least_seconds(ops: float, nbytes: float, peak: dict,
                  precision: str) -> float:
    """The least time the card could take: the larger of the operations
    at the ``precision``'s peak and the bytes at the memory's."""
    return max(ops / peak[precision], nbytes / peak["bytes"])


def matmul_work(m: int, k: int, n: int, x_bytes: float, w_bits: int,
                out_bytes: float, scale_bytes: float = 0.0) -> tuple:
    """(operations, bytes) of y[m, n] = x[m, k] @ w[k, n]: 2mkn operations;
    each input byte read once and each output byte written once (x, the
    packed weight at ``w_bits`` a value, its scales, y)."""
    ops = 2.0 * m * k * n
    nbytes = m * k * x_bytes + k * n * w_bits / 8.0 + scale_bytes \
        + m * n * out_bytes
    return ops, nbytes
