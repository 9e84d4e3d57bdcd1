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


# -- the CUDA kernel's launch plan and word-level decoders ------------------
# (csrc/qmatmul.cu runs only on the card; what it computes from shapes and
# bytes is reckoned here the way the kernel reckons it)

M_TILE = TQ.QMM_BLOCK_M
# (K, N): ViT-Base's three packed shapes, chip_smoke.py's ragged check
# shape and its small aligned one, a deep K that needs panel slabs
PLAN_SHAPES = [(768, 768), (768, 3072), (3072, 768), (203, 149), (48, 40),
               (8192, 300), (16, 8)]
PLAN_ROWS = [1, 133, 1576, 96 * 197]


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("k,n", PLAN_SHAPES)
@pytest.mark.parametrize("m", PLAN_ROWS)
def test_qmm_plan_covers_every_tile_once_within_shared_memory(m, k, n, sms):
    """Every (M tile, N panel) falls to exactly one block; a block's panel,
    x ring and staged output fit the 227 KB a Hopper block can use; the
    panel covers K in whole 128-byte chunks; about one block per SM."""
    for bits, layout in ((4, "splitk"), (3, "bitplanes"), (8, "splitk")):
        plan = TQ.qmm_plan(m, n, k, bits, layout, sms)
        bn, panels, m_tiles = plan["bn"], plan["panels"], plan["m_tiles"]
        assert bn in TQ.QMM_PANEL_WIDTHS and panels == -(-n // bn)
        assert m_tiles == -(-m // M_TILE)
        covered = np.zeros((panels, m_tiles), np.int64)
        for block in range(plan["blocks"]):
            panel, lo, hi = TQ.qmm_block_work(plan, block)
            assert lo < hi  # no block without work
            covered[panel, lo:hi] += 1
        assert (covered == 1).all()
        assert plan["blocks"] == panels * plan["ranges"]
        assert plan["blocks"] <= max(sms, panels)
        kp = -(-k // 128) * 128
        assert plan["slab"] % 128 == 0 and plan["slab"] * plan["slabs"] >= kp
        assert plan["slab"] * (plan["slabs"] - 1) < kp
        assert 2 <= plan["stages"] <= TQ.QMM_MAX_STAGES
        staged = 2 * M_TILE * bn * 4 + 3 * bn * 4
        stage = (1 if plan["turns"] else 2) * M_TILE * 128 + 16
        assert plan["turns"] == (bn == 128)
        want = plan["slab"] * bn + plan["stages"] * stage + staged + 1024
        assert plan["smem"] == want <= TQ.QMM_SMEM_MAX


@pytest.mark.parametrize("k,bn", [(768, 128), (3072, 32), (203, 128),
                                  (8192, 32)])
def test_qmm_plan_panel_width(k, bn):
    """The widest panel whose whole K fits: 128 columns at K = 768, 32 at
    K = 3072 (128 would be 384 KB); deeper K keeps 32 in slabs."""
    plan = TQ.qmm_plan(96 * 197, 3072, k, 4, "splitk", 132)
    assert plan["bn"] == bn
    assert (plan["slabs"] == 1) == (k <= 3072)
    if k == 768:  # 8 x 8 KB stages, the warpgroups taking turns
        assert plan["blocks"] == 120 and plan["stages"] == 8 and plan["turns"]
    if k == 3072:  # the ring takes what the panel leaves: 7 x 16 KB
        assert plan["stages"] == 7 and not plan["turns"]


@pytest.mark.parametrize("dtype,k,ptr,form", [
    (torch.int8, 768, 0, "tma"), (torch.int8, 3072, 256, "tma"),
    (torch.int8, 48, 16, "tma"), (torch.int8, 768, 8, "general"),
    (torch.int8, 203, 0, "general"), (torch.int8, 24, 0, "general"),
    (torch.int8, 0, 0, "general"), (torch.int32, 768, 0, "general"),
    (torch.float32, 768, 0, "general")])
def test_qmm_form_takes_tma_only_where_aligned(dtype, k, ptr, form):
    """TMA needs 16-byte-aligned rows and base: int8 x with K % 16 == 0."""
    assert TQ.qmm_form(dtype, k, ptr) == form


def _bytes_of(words):
    """uint32 words -> their 4 little-endian bytes, last axis."""
    return np.stack([(words >> np.uint32(8 * c)) & np.uint32(0xFF)
                     for c in range(4)], axis=-1).astype(np.uint8)


def _word(b4):
    """4 little-endian bytes (last axis) -> a uint32 word."""
    b4 = b4.astype(np.uint32)
    return b4[..., 0] | b4[..., 1] << 8 | b4[..., 2] << 16 | b4[..., 3] << 24


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, sel): result byte i is byte sel[i] of the
    8 bytes (x, y)."""
    pool = np.concatenate([_bytes_of(x), _bytes_of(y)], axis=-1)
    picks = [pool[..., (sel >> (4 * i)) & 7] for i in range(4)]
    return _word(np.stack(picks, axis=-1))


def _vsub4(a, b):
    """CUDA's __vsub4: per-byte a - b modulo 256."""
    return _word((_bytes_of(a).astype(np.int32)
                  - _bytes_of(np.full_like(a, b)).astype(np.int32)) & 0xFF)


def _spread4(nib):
    nib = nib.astype(np.uint32)
    return ((((nib * np.uint32(0x01010101)) & np.uint32(0x08040201))
             + np.uint32(0x7F7F7F7F)) >> np.uint32(7)) & np.uint32(0x01010101)


def _transpose4(r):
    t0 = _byte_perm(r[0], r[1], 0x5140)
    t1 = _byte_perm(r[0], r[1], 0x7362)
    t2 = _byte_perm(r[2], r[3], 0x5140)
    t3 = _byte_perm(r[2], r[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _cols4(payload_rows):
    """[..., N] uint8 rows (N % 4 == 0) -> [..., N/4] words of 4 columns."""
    b = payload_rows.reshape(*payload_rows.shape[:-1], -1, 4)
    return _word(b)


def _decode_bitplanes(planes, bits):
    """The kernel's bit-plane decoder: per plane word (4 columns of one
    byte group), each nibble spread into 4 bytes and OR'ed in at its plane,
    the offset subtracted per byte; returns int8 [8 * K/8, N]."""
    _, kg, n = planes.shape
    off4 = (1 << (bits - 1)) * 0x01010101
    lo = np.zeros((kg, n // 4, 4), np.uint32)
    hi = np.zeros_like(lo)
    for j in range(bits):
        word = _cols4(planes[j])  # [kg, n/4]
        for c in range(4):
            byte = (word >> np.uint32(8 * c)) & np.uint32(0xFF)
            lo[..., c] |= _spread4(byte & np.uint32(15)) << np.uint32(j)
            hi[..., c] |= _spread4(byte >> np.uint32(4)) << np.uint32(j)
    lo, hi = _vsub4(lo, off4), _vsub4(hi, off4)
    # word (kg, n4, c) holds rows 8kg..8kg+3 (lo) and +4..+7 (hi) of
    # column 4 n4 + c
    rows = np.concatenate([_bytes_of(lo), _bytes_of(hi)], axis=-1)
    return rows.reshape(kg, n, 8).transpose(0, 2, 1).reshape(8 * kg, n) \
        .view(np.int8)


def _decode_splitk(packed, bits, k):
    """The kernel's split-K decoder: for rows k..k+3 one payload word each
    (field j of packed row i = k - j*KR; the int8 row itself at 8 bits),
    masked per field, the offset subtracted per byte, and 4x4 bytes
    transposed; returns int8 [4 * ceil(K/4), N]."""
    kr, n = packed.shape
    words = _cols4(packed)  # [KR, N/4]
    mask4 = ((1 << bits) - 1) * 0x01010101
    off4 = (1 << (bits - 1)) * 0x01010101
    quads = -(-k // 4)
    out = np.zeros((4 * quads, n), np.uint8)
    for qd in range(quads):
        k0 = 4 * qd
        j = 0 if bits == 8 else k0 // kr
        i = k0 - j * kr
        r = []
        for e in range(4):
            while i >= kr:
                i -= kr
                j += 1
            if k0 + e < k:
                w = words[i]
                r.append(w if bits == 8 else _vsub4(
                    (w >> np.uint32(j * bits)) & np.uint32(mask4), off4))
            else:
                r.append(np.zeros(n // 4, np.uint32))
            i += 1
        cols = _transpose4(r)  # cols[c][n4]: rows k0..k0+3 of 4 n4 + c
        for c in range(4):
            out[k0:k0 + 4, c::4] = _bytes_of(cols[c]).T
    return out.view(np.int8)


def _all_bytes(shape, seed):
    """uint8 array of ``shape`` (last axis 256) whose every row holds
    every byte value, in a shuffled order."""
    rng = np.random.default_rng(seed)
    rows = [rng.permutation(256).astype(np.uint8)
            for _ in range(int(np.prod(shape[:-1])))]
    return np.stack(rows).reshape(shape)


@pytest.mark.parametrize("k", [96, 203, 37])
@pytest.mark.parametrize("bits", range(1, 9))
def test_bitplane_word_decoder_equals_unpack(bits, k):
    """The kernel's word-level bit-plane decoder equals unpack_bitplanes on
    planes holding every byte value, and on planes packed from a weight
    with K % 8 pad rows."""
    kg = -(-k // 8)
    planes = _all_bytes((bits, kg, 256), seed=bits)
    want = TQ.unpack_bitplanes(torch.from_numpy(planes), bits, k).numpy()
    np.testing.assert_array_equal(_decode_bitplanes(planes, bits)[:k], want)
    rng = np.random.default_rng(k)
    w = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(k, 12))
    planes = np.asarray(j_pack_bitplanes(w, bits))
    got = _decode_bitplanes(planes, bits)
    np.testing.assert_array_equal(got[:k], w.astype(np.int8))
    assert (got[k:] == 0).all()  # pad rows decode to 0


@pytest.mark.parametrize("k", [96, 203, 37, 5])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_splitk_word_decoder_equals_unpack(bits, k):
    """The kernel's word-level split-K decoder equals unpack_splitk on
    payloads holding every byte value (K % r pad rows included), and
    on a payload packed from a weight."""
    r = 8 // bits
    kr = k if bits == 8 else -(-k // r)
    payload = _all_bytes((kr, 256), seed=bits + k)
    if bits == 8:
        want = payload.view(np.int8)
    else:
        want = TQ.unpack_splitk(torch.from_numpy(payload), bits, k).numpy()
    np.testing.assert_array_equal(_decode_splitk(payload, bits, k)[:k], want)
    rng = np.random.default_rng(k)
    w = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(k, 12))
    payload = w.astype(np.int8).view(np.uint8) if bits == 8 \
        else np.asarray(j_pack_splitk(w, bits))
    got = _decode_splitk(payload, bits, k)
    np.testing.assert_array_equal(got[:k], w.astype(np.int8))
    assert (got[k:] == 0).all()


def test_spread4_over_every_nibble_and_byte():
    """spread4 puts bit e of a nibble into the low bit of byte e, for every
    nibble; applied to both nibbles it covers all 256 byte values."""
    for v in range(256):
        got = _bytes_of(np.array([_spread4(np.uint32(v & 15)),
                                  _spread4(np.uint32(v >> 4))],
                                 np.uint32)).reshape(-1)
        assert [int(b) for b in got] == [(v >> e) & 1 for e in range(8)]
