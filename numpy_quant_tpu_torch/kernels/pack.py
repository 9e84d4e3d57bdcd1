"""Packed sub-byte weight storage (int1..int8).

Port of ``numpy_quant_tpu/kernels/pack.py``. Two layouts hold a [K, N]
b-bit signed weight in exactly b bits per value, stored offset-binary
(v + 2^(b-1)) so that the packed bytes are unsigned:

* **split-K** (b in 1, 2, 4): uint8[KR, N], KR = ceil(K/r), r = 8/b.
  Byte (i, n) holds weight rows i + j*KR in bit field [j*b, (j+1)*b),
  so sub-product j contracts x's contiguous column block
  [j*KR, (j+1)*KR). At b == 8 the payload is the signed int8 weight
  itself (``tensor.pack_qtensor``).
* **bit-planes** (any b in 1..8): uint8[b, ceil(K/8), N]; row k takes bit
  k % 8 of ``planes[j, k // 8, n]`` for each plane j.

Packing runs once, on the host, with numpy (the same code as the JAX
package); the torch unpackers serve the "unpack" execution mode and the
kernels' plain versions. The CUDA kernels (``csrc/qmatmul.cu``) decode
tiles in shared memory and never build the [K, N] weight.
"""
from __future__ import annotations

import numpy as np
import torch


def pack_bitplanes(q: np.ndarray, bits: int) -> np.ndarray:
    """[K, N] signed b-bit integers -> uint8[b, ceil(K/8), N] bit-planes."""
    assert 1 <= bits <= 8
    q = np.asarray(q)
    assert q.ndim == 2, "pack_bitplanes packs 2-D weights"
    k, n = q.shape
    offset = 1 << (bits - 1)
    u = (q.astype(np.int64) + offset).astype(np.uint8)
    assert u.max(initial=0) < (1 << bits), "values exceed bit width"
    k8 = -(-k // 8) * 8
    if k8 != k:
        # pad rows encode VALUE 0 (offset-binary `offset`)
        u = np.concatenate([u, np.full((k8 - k, n), offset, np.uint8)],
                           axis=0)
    # [k8, n] -> [k8/8, 8, n]; bit j of each value -> plane j
    u = u.reshape(k8 // 8, 8, n)
    planes = np.zeros((bits, k8 // 8, n), dtype=np.uint8)
    for j in range(bits):
        bit = (u >> j) & 1  # [k8/8, 8, n]
        shifts = np.arange(8, dtype=np.uint8).reshape(1, 8, 1)
        planes[j] = np.sum(bit.astype(np.uint8) << shifts, axis=1,
                           dtype=np.uint8)
    return planes


def unpack_bitplanes_np(planes: np.ndarray, bits: int, k: int) -> np.ndarray:
    """Host inverse of pack_bitplanes: uint8[b, K/8, N] -> int8[K, N]."""
    planes = np.asarray(planes, np.uint8)
    kg, n = planes.shape[1], planes.shape[2]
    bitvals = (planes[:, :, None, :] >> np.arange(8).reshape(1, 1, 8, 1)) & 1
    weights = (1 << np.arange(bits)).reshape(bits, 1, 1, 1)
    vals = np.sum(bitvals.astype(np.int32) * weights, axis=0)
    vals = vals.reshape(kg * 8, n)[:k]
    offset = 1 << (bits - 1)
    return (vals - offset).astype(np.int8)


def pack_splitk(q: np.ndarray, bits: int) -> np.ndarray:
    """[K, N] signed b-bit integers -> uint8[ceil(K/r), N], r = 8//bits
    (b in 1, 2, 4), the split-K layout described in the module doc."""
    assert bits in (1, 2, 4), bits
    q = np.asarray(q)
    assert q.ndim == 2, "pack_splitk packs 2-D weights"
    k, n = q.shape
    r = 8 // bits
    kr = -(-k // r)
    offset = 1 << (bits - 1)
    u = (q.astype(np.int64) + offset).astype(np.uint8)
    assert u.max(initial=0) < (1 << bits), "values exceed bit width"
    if kr * r != k:
        # pad rows encode VALUE 0 (offset-binary `offset`)
        u = np.concatenate([u, np.full((kr * r - k, n), offset, np.uint8)],
                           axis=0)
    packed = np.zeros((kr, n), np.uint8)
    for j in range(r):
        packed |= u[j * kr:(j + 1) * kr] << np.uint8(j * bits)
    return packed


def unpack_splitk_np(packed: np.ndarray, bits: int, k: int) -> np.ndarray:
    """Host inverse of pack_splitk: uint8[KR, N] -> int8[K, N]."""
    packed = np.asarray(packed, np.uint8)
    r = 8 // bits
    mask = (1 << bits) - 1
    offset = 1 << (bits - 1)
    segs = [((packed >> (j * bits)) & mask).astype(np.int16) - offset
            for j in range(r)]
    return np.concatenate(segs, axis=0)[:k].astype(np.int8)


def unpack_stacked_np(planes: np.ndarray, bits: int, k: int) -> np.ndarray:
    """Host inverse of the tensor-parallel stacked layout
    (``"splitk_stacked"``): [S, KR_local, N] -> int8[K, N], S row groups of
    ceil(K/S) rows, each packed on its own."""
    planes = np.asarray(planes)
    s, n = planes.shape[0], planes.shape[2]
    kl = -(-k // s)
    if bits == 8:
        return planes.astype(np.int8).reshape(s * kl, n)[:k]
    segs = [unpack_splitk_np(planes[t], bits, kl) for t in range(s)]
    return np.concatenate(segs, axis=0)[:k]


def unpack_splitk(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Torch inverse of pack_splitk on the payload's device:
    uint8[KR, N] -> int8[K, N]."""
    r = 8 // bits
    mask = (1 << bits) - 1
    offset = 1 << (bits - 1)
    p = packed.to(torch.int32)
    segs = [((p >> (j * bits)) & mask) - offset for j in range(r)]
    return torch.cat(segs, dim=0)[:k].to(torch.int8)


def unpack_bitplanes(planes: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Torch inverse of pack_bitplanes on the payload's device:
    uint8[b, K/8, N] -> int8[K, N]."""
    kg, n = planes.shape[1], planes.shape[2]
    p = planes.to(torch.int32)[:, :, None, :]  # [b, K/8, 1, N]
    shifts = torch.arange(8, dtype=torch.int32,
                          device=planes.device).reshape(1, 1, 8, 1)
    weights = (1 << torch.arange(bits, dtype=torch.int32,
                                 device=planes.device)).reshape(bits, 1, 1, 1)
    vals = (((p >> shifts) & 1) * weights).sum(dim=0, dtype=torch.int32)
    vals = vals.reshape(kg * 8, n)[:k]
    return (vals - (1 << (bits - 1))).to(torch.int8)
