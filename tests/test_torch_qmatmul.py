"""The plain PyTorch versions of the port's packed-weight matmul kernels
(numpy_quant_tpu_torch.kernels.qmatmul) held against the JAX package's
Pallas ``splitk_qmatmul`` and ``packed_qmatmul`` (interpret mode,
TPU-mode numerics).

Expected: equality, bit for bit. Integer accumulation is exact and each
epilogue step rounds once in both. The scales are calibrated-looking (not
round), so that XLA folding ``x / scale`` into a reciprocal multiply
could move a value only at a rounding tie; any quantized output that
still differs is counted, printed and bounded to 1 LSB on at most 0.1%
of the outputs."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpy_quant_tpu.kernels.pack import pack_bitplanes as j_pack_bitplanes
from numpy_quant_tpu.kernels.pack import pack_splitk as j_pack_splitk
from numpy_quant_tpu.kernels.qmatmul import packed_qmatmul as j_packed
from numpy_quant_tpu.kernels.qmatmul import splitk_qmatmul as j_splitk
from numpy_quant_tpu_torch.kernels import qmatmul as TQ

X_SCALE, X_ZP = 0.0213, 3
W_SCALE = 0.0117
OUT_REQUANT = (0.0371, -5, 8)
# (per_channel, quantize_x, bias, out_requant): all 16 at the widths the
# ViT paths run (split-K 4 and 8, bit-planes 3), a covering four elsewhere
ALL = list(itertools.product((False, True), repeat=4))
PAIRWISE = [(False, True, False, False), (False, False, True, True),
            (True, True, True, False), (True, False, False, True)]


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _case(bits, m, k, n, variant, seed, layout):
    per_channel, quantize_x, has_bias, requant = variant
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int32)
    if layout == "splitk":
        payload = w.astype(np.int8) if bits == 8 else j_pack_splitk(w, bits)
    else:
        payload = j_pack_bitplanes(w, bits)
    colsum = w.sum(axis=0, keepdims=True).astype(np.int32)
    if quantize_x:
        x = (rng.normal(size=(m, k)) * 1.3).astype(np.float32)
    else:
        x = rng.integers(-128, 128, size=(m, k)).astype(
            np.int8 if seed % 2 else np.int32)
    kw = dict(bits=bits, bit_width=8, x_scale=X_SCALE,
              x_zp=None if seed % 3 == 0 else X_ZP, quantize_x=quantize_x,
              out_requant=OUT_REQUANT if requant else None)
    wvec = None
    if per_channel:
        wvec = rng.uniform(0.004, 0.02, size=(1, n)).astype(np.float32)
    else:
        kw["w_scale"] = W_SCALE
    bias = rng.normal(size=(1, n)).astype(np.float32) if has_bias else None
    return x, payload, colsum, bias, wvec, kw


def _compare(want, got, requant, bias):
    assert want.shape == got.shape and want.dtype == got.dtype
    if requant:
        diff = np.abs(want.astype(np.int64) - got.astype(np.int64))
        ties = int((diff > 0).sum())
        print(f"requantized outputs 1 LSB apart: {ties} of {want.size}")
        assert diff.max(initial=0) <= 1
        assert ties <= max(1, 0.01 * want.size)
    elif bias is None:
        np.testing.assert_array_equal(got, want)
    else:
        # XLA:CPU contracts the interpret-mode epilogue's f32(acc)*scale
        # + bias into one FMA; the port rounds the product first, as the
        # port's unpacked executor does. That moves y by at most one
        # rounding of the product and one of the sum.
        bound = np.spacing(np.abs(want) + np.abs(bias))
        off = int((got != want).sum())
        print(f"f32 outputs one rounding apart: {off} of {want.size}")
        assert (np.abs(got - want) <= bound).all()


def _run(jfn, tfn, case, **jextra):
    x, payload, colsum, bias, wvec, kw = case
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(payload),
                          jnp.asarray(colsum),
                          None if bias is None else jnp.asarray(bias),
                          None if wvec is None else jnp.asarray(wvec),
                          interpret=True, **jextra, **kw))
    got = tfn(torch.from_numpy(x), torch.from_numpy(payload),
              torch.from_numpy(colsum),
              None if bias is None else torch.from_numpy(bias),
              None if wvec is None else torch.from_numpy(wvec), **kw)
    _compare(want, got.numpy(), kw["out_requant"] is not None, bias)


SPLITK_CASES = [(b, v) for b in (4, 8) for v in ALL] \
    + [(b, v) for b in (1, 2) for v in PAIRWISE]
PACKED_CASES = [(3, v) for v in ALL] \
    + [(b, v) for b in (1, 2, 4, 5, 6, 7, 8) for v in PAIRWISE]


@pytest.mark.parametrize("bits,variant", SPLITK_CASES)
def test_splitk_reference_matches_jax(bits, variant):
    # K = 37 is no multiple of r = 8/bits; M and N are ragged too
    case = _case(bits, 19, 37, 21, variant, seed=bits + 7 * ALL.index(variant),
                 layout="splitk")
    _run(j_splitk, TQ.splitk_qmatmul_reference, case)


@pytest.mark.parametrize("bits,variant", PACKED_CASES)
def test_packed_reference_matches_jax(bits, variant):
    case = _case(bits, 19, 37, 21, variant, seed=bits + 7 * ALL.index(variant),
                 layout="bitplanes")
    _run(j_packed, TQ.packed_qmatmul_reference, case)


@pytest.mark.parametrize("bits", [3, 8])
def test_packed_reference_matches_jax_across_k_blocks(bits):
    """block_k < K: the JAX kernel carries its int32 accumulator over
    three K steps; the plain version contracts K at once."""
    case = _case(bits, 9, 300, 23, (True, True, True, True), seed=bits,
                 layout="bitplanes")
    _run(j_packed, TQ.packed_qmatmul_reference, case, block_k=128)


@pytest.mark.parametrize("layout", ["splitk", "bitplanes"])
def test_wrapper_takes_plain_version_on_cpu(layout):
    fn, ref = (TQ.splitk_qmatmul, TQ.splitk_qmatmul_reference) \
        if layout == "splitk" else \
        (TQ.packed_qmatmul, TQ.packed_qmatmul_reference)
    x, payload, colsum, bias, wvec, kw = _case(
        4, 5, 40, 9, (True, False, True, False), seed=1, layout=layout)
    args = (torch.from_numpy(x), torch.from_numpy(payload),
            torch.from_numpy(colsum), torch.from_numpy(bias),
            torch.from_numpy(wvec))
    before = fn.launches
    out = fn(*args, **kw)
    assert fn.launches == before
    np.testing.assert_array_equal(out.numpy(), ref(*args, **kw).numpy())


def test_wrapper_rejects_bad_operands():
    x, payload, colsum, _, _, kw = _case(4, 5, 40, 9, PAIRWISE[0], seed=1,
                                         layout="splitk")
    x, payload, colsum = (torch.from_numpy(a) for a in (x, payload, colsum))
    with pytest.raises(TypeError):  # quantize_x takes float32 x
        TQ.splitk_qmatmul(x.to(torch.int32), payload, colsum, **kw)
    with pytest.raises(ValueError):  # too few packed rows for K
        TQ.splitk_qmatmul(x, payload[:3], colsum, **kw)
    with pytest.raises(ValueError):  # split-K does not pack 3 bits
        TQ.splitk_qmatmul(x, payload, colsum, **dict(kw, bits=3))
    with pytest.raises(ValueError):  # both scale forms at once
        TQ.splitk_qmatmul(x, payload, colsum, None, np.ones((1, 9)), **kw)
    with pytest.raises(TypeError):  # bit-planes are [bits, K/8, N]
        TQ.packed_qmatmul(x, payload, colsum, **kw)
