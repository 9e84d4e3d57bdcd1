"""The port's weight packers and unpackers
(numpy_quant_tpu_torch.kernels.pack, tensor.pack_qtensor) held against the
JAX package's, byte for byte, at every width 1..8 with K odd and N
ragged. Expected: equality (integer code on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpy_quant_tpu.kernels import pack as JP
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu.tensor import pack_qtensor as j_pack_qtensor
from numpy_quant_tpu_torch.kernels import pack as TP
from numpy_quant_tpu_torch.tensor import PackedQTensor, QTensor, pack_qtensor

K, N = 37, 13


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _weight(bits, k=K, n=N, seed=0):
    rng = np.random.default_rng(seed + bits)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int32)
    w[0, :] = lo  # both ends of the range appear
    w[1, :] = hi
    return w


@pytest.mark.parametrize("bits", range(1, 9))
def test_bitplanes_match_jax(bits):
    w = _weight(bits)
    planes = TP.pack_bitplanes(w, bits)
    want = JP.pack_bitplanes(w, bits)
    assert planes.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(planes, want)
    np.testing.assert_array_equal(TP.unpack_bitplanes_np(planes, bits, K),
                                  JP.unpack_bitplanes_np(want, bits, K))
    got = TP.unpack_bitplanes(torch.from_numpy(planes), bits, K)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JP.unpack_bitplanes(jnp.asarray(want), bits, K)))
    np.testing.assert_array_equal(got.numpy(), w.astype(np.int8))


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("k", [K, 40, 3])
def test_splitk_matches_jax(bits, k):
    w = _weight(bits, k=k)
    packed = TP.pack_splitk(w, bits)
    want = JP.pack_splitk(w, bits)
    assert packed.shape == (-(-k // (8 // bits)), N)
    np.testing.assert_array_equal(packed, want)
    np.testing.assert_array_equal(TP.unpack_splitk_np(packed, bits, k),
                                  JP.unpack_splitk_np(want, bits, k))
    got = TP.unpack_splitk(torch.from_numpy(packed), bits, k)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JP.unpack_splitk(jnp.asarray(want), bits, k)))
    np.testing.assert_array_equal(got.numpy(), w.astype(np.int8))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shards", [2, 3])
def test_unpack_stacked_matches_jax(bits, shards):
    """The tensor-parallel stacked layout's host inverse: S row groups of
    ceil(K/S) rows, each packed on its own."""
    w = _weight(bits)
    kl = -(-K // shards)
    rows = np.zeros((shards * kl, N), np.int32)
    rows[:K] = w
    groups = [rows[t * kl:(t + 1) * kl] for t in range(shards)]
    planes = np.stack([g.astype(np.int8) if bits == 8
                       else TP.pack_splitk(g, bits) for g in groups])
    got = TP.unpack_stacked_np(planes, bits, K)
    np.testing.assert_array_equal(got, JP.unpack_stacked_np(planes, bits, K))
    np.testing.assert_array_equal(got, w.astype(np.int8))


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_qtensor_matches_jax(bits):
    w = _weight(bits)
    scale = np.float32(0.0123)
    tp = pack_qtensor(QTensor(torch.from_numpy(w), bits, scale))
    jp = j_pack_qtensor(JQTensor(jnp.asarray(w), bits, scale))
    assert isinstance(tp, PackedQTensor)
    assert (tp.layout, tp.k, tp.n, tp.bit_width) == \
        (jp.layout, jp.k, jp.n, jp.bit_width)
    assert tp.layout == ("splitk" if bits in (1, 2, 4, 8) else "bitplanes")
    assert tp.planes.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(tp.planes.numpy(), np.asarray(jp.planes))
    np.testing.assert_array_equal(tp.colsum.numpy(), np.asarray(jp.colsum))
    un = tp.unpack()
    assert un.bit_width == bits and un.zero_point is None
    np.testing.assert_array_equal(un.data.numpy(), w.astype(np.int8))
    np.testing.assert_array_equal(un.data.numpy(),
                                  np.asarray(jp.unpack().data))
