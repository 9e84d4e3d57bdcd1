"""The port's elementwise quantize/dequantize (kernels/elementwise.py)
held against the JAX package on the CPU, where the wrappers take their
plain versions.

* The plain versions equal JAX's eager ``quantize``/``dequantize`` bit for
  bit: in TPU mode (x64 off) at 1-8 bits and for the 32-bit biases of an
  8-bit model; in x64 mode at 9-16, 32 and 64 bits (int64 containers).
* Against ``quantize_pallas``/``dequantize_pallas`` in interpret mode the
  plain versions differ only where x / scale + zp lies on a rounding tie
  (interpret mode folds the divide into a reciprocal multiply); the count
  is printed.
* The kernels' plan (x as rows x columns in its memory order, each
  broadcast scale and zero point read at a row offset plus a column
  stride, with multiply-shift divisions) is replayed on the CPU over every
  layout the executor hands them, dense rows read in place.
* ``fake_quantize``'s plain version equals the plain chain, and JAX's
  ``dequantize(quantize(...))``, bit for bit.
* On a meta tensor both wrappers raise: nothing falls back."""
import jax
import numpy as np
import pytest
import torch

from numpy_quant_tpu import quantization as JQ
from numpy_quant_tpu.kernels.elementwise import (dequantize_pallas,
                                                 quantize_pallas)
from numpy_quant_tpu_torch import quantization as TQ
from numpy_quant_tpu_torch.kernels import elementwise as E

TPU_WIDTHS = list(range(1, 9))
X64_WIDTHS = list(range(9, 17)) + [32, 64]


def _t(a):
    return torch.from_numpy(np.array(a))


def _mode(bits):
    """JAX's mode for a width: TPU mode to 8 bits, x64 above."""
    return jax.enable_x64(bits > 8)


def _inputs(bits: int, seed: int, scale: float, zp):
    """Values across the grid, exact ties (k + 1/2) * scale, zeros,
    infinities and values beyond the clip (positive ones only where the
    f32 clip bound is exact, so no conversion overflows)."""
    rng = np.random.default_rng(seed)
    lo, hi = TQ.qrange(bits)
    span = min(hi, 2.0 ** 20)
    x = rng.uniform(-1.2 * span, 1.2 * span, size=300) * scale
    k = rng.integers(-int(min(span, 1000)) - 1, int(min(span, 1000)) + 1,
                     size=60)
    ties = (k + 0.5) * scale
    far = [-np.inf, lo * scale * 4.0, 0.0, -0.0]
    if bits <= 24:
        far += [np.inf, hi * scale * 4.0]
    x = np.concatenate([x, ties, far]).astype(np.float32)
    if zp is not None and bits > 24:
        x = x[np.isfinite(x) & (x <= 0)]  # zp + x stays below 2^(b-1)
    return x


def _scale_zp(bits, asym):
    scale = np.float32(0.0173 * 2.0 ** -(max(bits, 8) - 8))
    zp = np.int64(-(2 ** (bits - 2)) + 3) if asym and bits > 1 else None
    return scale, zp


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("bits", TPU_WIDTHS + X64_WIDTHS)
def test_quantize_plain_matches_jax(bits, asym):
    scale, zp = _scale_zp(bits, asym)
    x = _inputs(bits, seed=bits + 100 * asym, scale=scale, zp=zp)
    with _mode(bits):
        want = np.asarray(JQ.quantize(x, bits, scale, zp))
    got = TQ.quantize(_t(x), bits, scale, zp)
    assert got.dtype == (torch.int64 if bits > 8 else torch.int32)
    assert want.dtype == (np.int64 if bits > 8 else np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    if bits <= 8:  # the int8 form holds the same values
        np.testing.assert_array_equal(
            E.quantize(_t(x), bits, scale, zp, out_dtype=torch.int8).numpy(),
            want)


@pytest.mark.parametrize("asym", [False, True])
def test_quantize_32_bit_biases_of_an_8_bit_model(asym):
    """An 8-bit model's biases: 32 bits in int32 containers, TPU mode
    (values inside the int32 range; the clip bound itself is the card's
    conversion, held in chip_smoke.py)."""
    scale = np.float32(3.1e-6)
    zp = np.int64(17) if asym else None
    rng = np.random.default_rng(32 + asym)
    x = (rng.normal(size=500) * 1e3).astype(np.float32)
    x[:3] = [-1e9, -np.inf, 0.0]
    with jax.enable_x64(False):
        want = np.asarray(JQ.quantize(x, 32, scale, zp))
    got = TQ.quantize(_t(x), 32, scale, zp, container=torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_quantize_per_channel_scale(bits, per_channel):
    """A weight's per-channel scale row ([1, N] and [N, 1]) broadcasts as
    it does in JAX."""
    rng = np.random.default_rng(bits)
    for axis in (0, 1):
        w = rng.normal(size=(24, 13)).astype(np.float32)
        s = JQ.per_channel_scales(w, bits, axis) if per_channel \
            else np.float32(0.01)
        with _mode(bits):
            want = np.asarray(JQ.quantize(w, bits, s, None))
        np.testing.assert_array_equal(TQ.quantize(_t(w), bits, s, None)
                                      .numpy(), want)


def _dequant_cases(bits: int, rng):
    """(q, zero point) pairs: no zp, a scalar, and the accumulator's
    correction tensors ([M, 1] row sums, [1, N] column sums, full)."""
    lo, hi = TQ.qrange(bits)
    q = rng.integers(int(lo), int(min(hi, 2.0 ** 62)) + 1, size=(9, 14),
                     dtype=np.int64)
    big = 2 ** min(bits - 1, 40)
    return [(q, None), (q, np.int64(-3)),
            (q, rng.integers(-big, big, size=(9, 1))),
            (q, rng.integers(-big, big, size=(1, 14))),
            (q, rng.integers(-big, big, size=(9, 14)))]


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("bits", TPU_WIDTHS + X64_WIDTHS)
def test_dequantize_plain_matches_jax(bits, per_channel):
    rng = np.random.default_rng(1000 + bits + 50 * per_channel)
    scale = (rng.uniform(0.001, 0.1, size=(1, 14)).astype(np.float32)
             if per_channel else np.float32(0.0137))
    idt = np.int64 if bits > 8 else np.int32
    for q, zp in _dequant_cases(bits, rng):
        if bits <= 8 and zp is not None:
            zp = np.asarray(zp).astype(np.int32)  # TPU-mode corrections
        q = q.astype(idt)
        with _mode(bits):
            want = np.asarray(JQ.dequantize(
                q, scale, None if zp is None else np.asarray(zp)))
        tzp = zp if zp is None or np.ndim(zp) == 0 else _t(zp)
        got = TQ.dequantize(_t(q), scale, tzp)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        if bits <= 8:  # int8 storage dequantizes to the same floats
            np.testing.assert_array_equal(
                TQ.dequantize(_t(q.astype(np.int8)), scale, tzp).numpy(),
                want)


def test_dequantize_wide_accumulator_rounds_once():
    """An int64 accumulator beyond 2^24: x64 mode takes one f64 product
    rounded to f32; converting to f32 first would round twice."""
    q = np.array([2 ** 40 + 3, -(2 ** 35) - 1, 2 ** 24 + 1], np.int64)
    scale = np.float32(0.1)
    with jax.enable_x64(True):
        want = np.asarray(JQ.dequantize(q, scale, None))
    got = TQ.dequantize(_t(q), scale, None).numpy()
    np.testing.assert_array_equal(got, want)
    twice = (q.astype(np.float32) * scale).astype(np.float32)
    assert (got != twice).any()


@pytest.mark.parametrize("kind", ["float", "float64", "float32"])
def test_wide_dequantize_takes_a_scalar_scale_unrounded(kind):
    """x64 mode multiplies an int64 accumulator by a float64 of the scale:
    a Python or float64 scalar is not rounded to f32 first. The kernel
    gets the scalar by value in both precisions."""
    scale = {"float": 0.0213, "float64": np.float64(0.0213),
             "float32": np.float32(0.0213)}[kind]
    q = np.random.default_rng(5).integers(-2 ** 40, 2 ** 40, size=64)
    with jax.enable_x64(True):
        want = np.asarray(JQ.dequantize(q, scale, np.int64(-3)))
    got = TQ.dequantize(_t(q), scale, np.int64(-3)).numpy()
    np.testing.assert_array_equal(got, want)
    rounded = TQ.dequantize(_t(q), np.float32(scale), np.int64(-3)).numpy()
    assert (got != rounded).any() == (kind != "float32")
    by_value = E._scale_values(E._op_args(_t(q), scale, np.int64(-3))[0])
    assert by_value == (float(np.float32(scale)), float(scale))


@pytest.mark.parametrize("fn", ["dequantize", "fake_quantize"])
def test_wide_zero_point_is_subtracted_exactly(fn):
    """An int64 dequantize subtracts a scalar zero point past 2^53 exactly,
    through the custom op as through the plain chain (the op takes it as
    an int, not a float)."""
    zp = np.int64(3 - 2 ** 62)
    scale = np.float32(2.0 ** -62)
    rng = np.random.default_rng(64)
    rounded = np.int64(int(float(zp)))                   # 2^53 apart
    if fn == "dequantize":
        q = _t(zp + rng.integers(-10 ** 6, 10 ** 6, size=64))
        got = E.dequantize(q, scale, zp)
        want = E.dequantize_reference(q, scale, zp)
        off = E.dequantize_reference(q, scale, rounded)
    else:
        x = _t((rng.integers(-10 ** 6, 10 ** 6, size=64) + 0.5)
               .astype(np.float32) * scale)
        got = E.fake_quantize(x, 64, scale, zp, torch.int64)
        want = E.fake_quantize_reference(x, 64, scale, zp, torch.int64)
        off = E.dequantize_reference(E.quantize_reference(
            x, 64, scale, zp, torch.int64), scale, rounded)
    assert torch.equal(got, want)
    assert not torch.equal(got, off)


def test_zero_point_added_in_f64_above_8_bits():
    """x / scale + zp rounds differently in f32 (TPU mode, and the TPU
    kernel) than in f64 (x64 mode): 3 + 0.49999997 is 3.5 in f32 (rint 4)
    and 3.49999997 in f64 (rint 3)."""
    x = np.array([np.nextafter(np.float32(0.5), np.float32(0))], np.float32)
    scale, zp = np.float32(1.0), np.int64(3)
    with jax.enable_x64(False):
        tpu = np.asarray(JQ.quantize(x, 8, scale, zp))
        pallas = np.asarray(quantize_pallas(jax.numpy.asarray(x), bit_width=8,
                                            scale=float(scale), zero_point=3,
                                            interpret=True))
    with jax.enable_x64(True):
        x64 = np.asarray(JQ.quantize(x, 16, scale, zp))
    assert tpu[0] == pallas[0] == 4 and x64[0] == 3
    assert TQ.quantize(_t(x), 8, scale, zp).item() == 4
    assert TQ.quantize(_t(x), 16, scale, zp).item() == 3
    # the int32 form of a wide width keeps the TPU kernel's f32 add
    assert E.quantize(_t(x), 16, scale, zp, out_dtype=torch.int32).item() == 4


@pytest.mark.parametrize("bits", [2, 8, 16])
def test_zero_scale_quantizes_0_over_0_to_0(bits):
    """A constant tensor's zero scale: 0/0 -> 0, x/0 -> the clip bounds,
    as XLA's float->int conversion gives them."""
    x = np.array([0.0, 1.5, -2.0, 0.0], np.float32)
    for zp in (None, np.int64(1)):
        with _mode(bits):
            want = np.asarray(JQ.quantize(x, bits, np.float32(0.0), zp))
        got = TQ.quantize(_t(x), bits, np.float32(0.0), zp).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0] == 0 and got[3] == 0


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_bf16_input_widens_exactly(bits):
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.normal(size=(7, 33)).astype(np.float32)) \
        .to(torch.bfloat16)
    scale, zp = np.float32(0.0213 * 2.0 ** -(max(bits, 8) - 8)), np.int64(5)
    with _mode(bits):
        want = np.asarray(JQ.quantize(x.float().numpy(), bits, scale, zp))
    np.testing.assert_array_equal(TQ.quantize(x, bits, scale, zp).numpy(),
                                  want)


@pytest.mark.parametrize("bits", [1, 3, 4, 7, 8, 9, 12, 16])
def test_plain_against_interpret_pallas(bits):
    """quantize_pallas (f32 zp add, int8 at <= 8 bits, int32 above) against
    the plain version's same form: differences only at rounding ties, by
    one step. dequantize_pallas equals the plain version."""
    rng = np.random.default_rng(7 * bits)
    scale, zp = _scale_zp(bits, True)
    scale = float(scale)
    lo, hi = TQ.qrange(bits)
    x = np.concatenate([
        rng.uniform(lo, hi, size=(16, 40)).reshape(-1),
        (rng.integers(int(lo), int(hi) + 1, size=320) + 0.5)]) \
        .astype(np.float32) * np.float32(scale)
    x = x.reshape(20, 48)
    out = torch.int8 if bits <= 8 else torch.int32
    with jax.enable_x64(False):
        want = np.asarray(quantize_pallas(jax.numpy.asarray(x),
                                          bit_width=bits, scale=scale,
                                          zero_point=None if zp is None
                                          else int(zp), interpret=True))
    got = E.quantize_reference(_t(x), bits, np.float32(scale), zp,
                               out_dtype=out).numpy()
    assert got.dtype == want.dtype
    differ = got.astype(np.int64) != want.astype(np.int64)
    # a tie: the exact x / scale + zp within two f32 ulps of its operands
    # of a k + 1/2 boundary, where a reciprocal multiply or a fused
    # multiply-add rounds it to the other side
    q = x.astype(np.float64) / np.float64(np.float32(scale))
    v = q + (0 if zp is None else float(zp))
    mag = np.maximum(np.abs(q), np.abs(v)).astype(np.float32)
    tie = np.abs(np.abs(v - np.floor(v)) - 0.5) <= 2 * np.spacing(mag)
    print(f"{bits} bits: {int(differ.sum())} of {differ.size} differ from "
          f"interpret-mode quantize_pallas, all at ties")
    assert not (differ & ~tie).any()
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1
    q = rng.integers(int(lo), int(hi) + 1, size=(20, 48)).astype(
        np.int8 if bits <= 8 else np.int32)
    with jax.enable_x64(False):
        dwant = np.asarray(dequantize_pallas(
            jax.numpy.asarray(q), scale=scale,
            zero_point=None if zp is None else int(zp), interpret=True))
    np.testing.assert_array_equal(
        E.dequantize_reference(_t(q), np.float32(scale), zp).numpy(), dwant)


@pytest.mark.parametrize("container", ["int8", "int32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("bits", TPU_WIDTHS)
def test_fake_quantize_matches_the_chain_and_jax(bits, per_channel, dtype,
                                                 container):
    """fake_quantize's plain version equals quantize then dequantize (the
    plain chain) and JAX's dequantize(quantize(...)) in TPU mode, bit for
    bit, with a scalar and a per-channel scale."""
    rng = np.random.default_rng(bits + 10 * per_channel)
    scale, zp = _scale_zp(bits, True)
    x = np.concatenate([_inputs(bits, bits, scale, zp)[:240],
                        rng.normal(size=24).astype(np.float32)])
    x = x[np.isfinite(x)][:240].reshape(20, 12)
    xt = _t(x).to(getattr(torch, dtype))
    if per_channel:
        scale = (scale * rng.uniform(0.5, 2.0, size=(1, 12))) \
            .astype(np.float32)
    ctype = getattr(torch, container)
    got = E.fake_quantize(xt, bits, scale, zp, container=ctype)
    chain = E.dequantize_reference(
        E.quantize_reference(xt, bits, scale, zp, ctype), scale, zp)
    assert got.dtype == torch.float32 and got.shape == xt.shape
    assert torch.equal(got, chain)
    assert torch.equal(E.fake_quantize_reference(xt, bits, scale, zp, ctype),
                       chain)
    with jax.enable_x64(False):
        xj = xt.float().numpy()
        want = np.asarray(JQ.dequantize(JQ.quantize(xj, bits, scale, zp),
                                        scale, zp))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fake_quantize_on_the_cpu_counts_nothing_and_reads_views():
    """A CPU call takes the plain version (no launch), and a view of dense
    rows gives what its dense copy gives."""
    before = E.fake_quantize.launches
    probs = torch.rand(2, 3, 1, 10)
    view = probs[..., :9]
    got = TQ.fake_quantize(view, 8, np.float32(1 / 255), np.int64(-128),
                           container=torch.int8)
    assert torch.equal(got, E.fake_quantize_reference(
        view.contiguous(), 8, np.float32(1 / 255), np.int64(-128)))
    assert got.is_contiguous() and E.fake_quantize.launches == before


def _row_offset(walk, r: int) -> int:
    """The kernel's row offset: the digits of r, innermost first, each
    but the outermost divided off by its multiply-shift."""
    off = 0
    for d, (size, stride) in enumerate(walk.rows):
        if d == len(walk.rows) - 1:
            return off + r * stride
        magic, shift = walk.magic[d]
        q = (r * magic) >> shift
        assert q == r // size
        off += (r - q * size) * stride
        r = q
    return off


def _storage(t: torch.Tensor) -> torch.Tensor:
    """t's storage from its first element on, as a flat tensor."""
    return t.as_strided((t.untyped_storage().nbytes() // t.element_size()
                         - t.storage_offset(),), (1,))


def _replay_plan(x: torch.Tensor, op: torch.Tensor):
    """What the kernel reads, by its plan, for each output element: x at
    r * x_rs + c, the operand at row_offset(r) + c * col_stride. Returned
    as (x read, operand read) with the output's shape and strides (dense
    in x's memory order), and the operand's form."""
    pl = E.plan(tuple(x.shape), x.stride(), x.element_size(), 4, None,
                (tuple(op.shape), op.stride()))
    assert not pl.copy
    walk = pl.zp
    xs, ops = _storage(x), _storage(op)
    got_x = torch.empty_like(x)
    got_op = torch.empty_like(x, dtype=op.dtype)
    assert got_x.stride() == got_op.stride()
    gx, gop = _storage(got_x), _storage(got_op)
    for r in range(pl.rows):
        ro = _row_offset(walk, r)
        for c in range(pl.cols):
            gx[r * pl.cols + c] = xs[r * pl.x_rs + c]
            gop[r * pl.cols + c] = ops[ro + c * walk.col_stride]
    return got_x, got_op, walk.form


def _layouts():
    """(data, operand, the plan's form) in the layouts the executor
    produces."""
    g = torch.Generator().manual_seed(0)

    def ints(*shape):
        return torch.randint(-99, 99, shape, generator=g, dtype=torch.int64)

    acc = ints(2, 5, 6)
    conv = ints(2, 3, 3, 4).permute(0, 3, 1, 2)          # NHWC acc as NCHW
    heads = ints(2, 5, 3, 4).permute(0, 2, 1, 3)          # [B, H, N, D]
    probs = ints(2, 3, 1, 10)[..., :9]                    # dense rows
    return [
        (acc, ints(1, 6), "inner"),                       # column sums
        (acc, ints(2, 5, 1), "outer"),                    # row sums
        (acc, ints(2, 5, 6), "full"),                     # full
        (acc, ints(6).float(), "inner"),                  # per-channel row
        (conv, ints(1, 4, 1, 1), "inner"),                # conv colsums
        (conv, ints(2, 3, 3, 4).permute(0, 3, 1, 2), "full"),  # conv full
        (heads, ints(2, 3, 5, 1), "outer"),               # permuted rows
        (heads, heads.transpose(-1, -2).contiguous().transpose(-1, -2),
         "general"),
        (acc.transpose(0, 2), ints(6, 1, 1), "inner"),    # transposed
        (ints(7, 1, 5), ints(1, 1, 5), "inner"),          # size-1 dims
        (probs, ints(2, 3, 1, 1), "outer"),               # strided rows
        (conv, ints(4, 1, 1).float(), "inner"),           # NHWC channel row
    ]


@pytest.mark.parametrize("case", range(12))
def test_kernel_operand_walk_replayed(case):
    """The plan's reads, replayed as the kernel makes them, give x's
    values and the operand broadcast to x, in the form the plan names,
    into an output dense in x's memory order."""
    x, op, form = _layouts()[case]
    got_x, got_op, got_form = _replay_plan(x, op)
    assert got_form == form
    assert torch.equal(got_x, x)
    assert torch.equal(got_op, op.expand(x.shape))
    layout = E._x_layout(tuple(got_op.shape), got_op.stride())
    assert layout is not None and layout[2] is None     # dense


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 12, 197, 768, 2049, 3072,
                               65535, 2 ** 20 + 1, 2 ** 31 - 1])
def test_magic_division_holds_over_the_index_range(d):
    magic, shift = E.magic_div(d)
    rng = np.random.default_rng(d)
    ks = rng.integers(0, max(1, (2 ** 31 - 2) // d), size=500)
    rs = np.concatenate([np.arange(0, min(4 * d + 3, 4000)),
                         [2 ** 31 - 1, 2 ** 31 - 2], ks * d, ks * d + d - 1,
                         rng.integers(0, 2 ** 31, size=1000)])
    for r in rs.tolist():
        assert (r * magic) >> shift == r // d
        assert r * magic < 2 ** 64


def test_plan_forms_and_grid():
    """The plan of the main path's shapes: a scalar call's long dense run
    is cut into rows of a width that divides it; a [1, N] zero point on an
    accumulator is inner, an [M, 1] one outer; 16-byte vectors on the
    narrow side; a small launch with scalar operands takes narrow vectors
    (16 bytes of the wide side) over more threads."""
    pl = E.plan((18912, 3072), (3072, 1), 4, 2, None,
                ((1, 3072), (3072, 1)))
    assert (pl.rows, pl.cols, pl.x_rs, pl.vec) == (18912, 3072, 3072, 8)
    assert pl.zp.form == "inner" and pl.bx * pl.vec * 3 == 3072
    pl = E.plan((18912, 3072), (3072, 1), 4, 4, ((1, 3072), (3072, 1)),
                ((18912, 1), (1, 1)))
    assert (pl.scale.form, pl.zp.form) == ("inner", "outer")
    pl = E.plan((8, 32, 2048, 64), (2 ** 22, 2 ** 17, 64, 1), 4, 1)
    assert (pl.rows, pl.cols, pl.vec) == (8192, 4096, 16)  # a long run cut
    assert not pl.narrow                                # fills the card
    pl = E.plan((1073 * 97,), (1,), 4, 4)                   # no width divides
    assert (pl.rows, pl.cols) == (1, 1073 * 97)
    pl = E.plan((8, 32, 1, 2048), (32 * 2049, 2049, 2049, 1), 4, 1)
    assert (pl.copy, pl.rows, pl.cols, pl.x_rs) == (False, 256, 2048, 2049)
    assert (pl.narrow, pl.vec) == (True, 4)             # p_past
    pl = E.plan((64, 64), (64, 1), 4, 1)
    assert pl.bx * pl.by == E.NQ_THREADS
    assert (pl.narrow, pl.vec, pl.rows, pl.cols) == (True, 4, 1, 4096)
    assert -(-pl.cols // (pl.bx * pl.vec)) == 4 and pl.rows <= pl.by
    pl = E.plan((64, 64), (64, 1), 4, 1, ((1, 64), (64, 1)))
    assert (pl.narrow, pl.vec) == (False, 16)           # a tensor operand
    for shape in ((8, 4, 1, 64), (8, 32, 1, 64)):       # cache write, q
        pl = E.plan(shape, torch.empty(shape).stride(), 4, 1)
        assert (pl.narrow, pl.vec) == (True, 4)
        pl = E.plan(shape, torch.empty(shape).stride(), 2, 4)  # bf16 fake
        assert (pl.narrow, pl.vec) == (True, 4)


def test_non_dense_data_is_copied_in_its_order():
    """A view of dense rows with one row stride (DecodeAttention's
    probs[..., :L]) is read where it lies; any other non-dense view is
    copied dense first, in its own dim order."""
    rows = torch.zeros(2, 3, 1, 9)[..., :8]
    pl = E.plan(tuple(rows.shape), rows.stride(), 4, 1)
    assert not pl.copy and pl.x_rs == 9
    t = torch.zeros(4, 6, 5).permute(2, 0, 1)[:3]    # rows over two dims
    assert not E.plan(tuple(t.shape), t.stride(), 4, 1).copy
    base = torch.arange(60, dtype=torch.float32).reshape(3, 4, 5)
    for x in (base[:, 1:3, :3], base[..., ::2], base.expand(2, 3, 4, 5)):
        assert E.plan(tuple(x.shape), x.stride(), 4, 1).copy
        dense = torch.empty_like(x).copy_(x)
        pl = E.plan(tuple(dense.shape), dense.stride(), 4, 1)
        assert not pl.copy and torch.equal(dense, x) and pl.rows == 1


@pytest.mark.parametrize("fn", ["quantize", "dequantize", "fake_quantize"])
def test_meta_tensors_raise(fn):
    """Only CPU tensors take the plain version; a CUDA tensor launches the
    kernel; anything else raises instead of falling back."""
    if fn == "fake_quantize":
        x = torch.empty(4, 8, device="meta")
        with pytest.raises(ValueError, match="no fake_quantize kernel"):
            E.fake_quantize(x, 8, 0.1, 3)
    elif fn == "quantize":
        x = torch.empty(4, 8, device="meta")
        with pytest.raises(ValueError, match="no quantize kernel"):
            E.quantize(x, 8, 0.1, 3)
        with pytest.raises(ValueError, match="no quantize kernel"):
            TQ.quantize(x, 16, 0.1, None)
    else:
        q = torch.empty(4, 8, device="meta", dtype=torch.int32)
        with pytest.raises(ValueError, match="no dequantize kernel"):
            E.dequantize(q, 0.1, 3)
        with pytest.raises(ValueError, match="no dequantize kernel"):
            TQ.requantize(q, 0.1, None, 0.2, 1, 8)


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    before = (E.quantize.launches, E.dequantize.launches)
    q = TQ.quantize(torch.ones(5), 12, 0.5, 1)
    TQ.dequantize(q, 0.5, 1, dtype=torch.bfloat16)
    assert (E.quantize.launches, E.dequantize.launches) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        E.quantize(torch.ones(3, dtype=torch.float64), 8, 0.1, None)
    with pytest.raises(ValueError):
        E.quantize(torch.ones(3), 9, 0.1, None, out_dtype=torch.int8)
    with pytest.raises(TypeError):
        E.dequantize(torch.ones(3, dtype=torch.int16), 0.1, None)
    with pytest.raises(TypeError):
        E.dequantize(torch.ones(3, dtype=torch.int32), 0.1, None,
                     out_dtype=torch.float64)
