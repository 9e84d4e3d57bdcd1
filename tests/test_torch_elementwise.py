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
* The kernels' operand walk (the broadcast scale and zero point read in the
  data's memory order) is replayed on the CPU over every layout the
  executor hands them.
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
    _, p, _, _ = E._operands(_t(q), scale, np.int64(-3))
    assert p.scale_d == float(scale) and p.scale == float(np.float32(scale))


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


def _replay_walk(x: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """What the kernel reads from ``op`` for each element of ``x``: storage
    position j of x -> j's digits over the walk's dims -> op's offset.
    Returned with x's shape and strides, for a logical comparison."""
    dims = E._memory_order(x)
    assert dims is not None
    b = E._walk(op, x.shape, dims)
    flat = op.as_strided((op.untyped_storage().nbytes() // op.element_size()
                          - op.storage_offset(),), (1,))
    got = torch.empty_like(x, dtype=op.dtype)
    store = got.as_strided((x.numel(),), (1,))
    for j in range(x.numel()):
        r, off = j, 0
        for d in reversed(range(b.ndim)):
            r, digit = divmod(r, b.size[d])
            off += digit * b.stride[d]
        store[j] = flat[off]
    return got


def _layouts():
    """(data, operand) pairs in the layouts the executor produces."""
    g = torch.Generator().manual_seed(0)

    def ints(*shape):
        return torch.randint(-99, 99, shape, generator=g, dtype=torch.int64)

    acc = ints(2, 5, 6)
    conv = ints(2, 3, 3, 4).permute(0, 3, 1, 2)          # NHWC acc as NCHW
    heads = ints(2, 5, 3, 4).permute(0, 2, 1, 3)          # [B, H, N, D]
    return [
        (acc, ints(1, 6)),                                # column sums
        (acc, ints(2, 5, 1)),                             # row sums
        (acc, ints(2, 5, 6)),                             # full
        (acc, ints(6).float()),                           # per-channel row
        (conv, ints(1, 4, 1, 1)),                         # conv colsums
        (conv, ints(2, 3, 3, 4).permute(0, 3, 1, 2)),     # conv full
        (heads, ints(2, 3, 5, 1)),                        # permuted rows
        (heads, heads.transpose(-1, -2).contiguous().transpose(-1, -2)),
        (acc.transpose(0, 2), ints(6, 1, 1)),             # transposed
        (ints(7, 1, 5), ints(1, 1, 5)),                   # size-1 dims
    ]


@pytest.mark.parametrize("case", range(10))
def test_kernel_operand_walk_replayed(case):
    x, op = _layouts()[case]
    want = op.expand(x.shape)
    got = _replay_walk(x, op)
    assert torch.equal(got, want)
    assert got.stride() == x.stride()


def test_non_dense_data_is_copied_in_its_order():
    x = torch.arange(60, dtype=torch.float32).reshape(3, 4, 5)[:, ::2, 1:]
    assert E._memory_order(x) is None
    dense = torch.empty_like(x).copy_(x)
    assert E._memory_order(dense) is not None and torch.equal(dense, x)


@pytest.mark.parametrize("fn", ["quantize", "dequantize"])
def test_meta_tensors_raise(fn):
    """Only CPU tensors take the plain version; a CUDA tensor launches the
    kernel; anything else raises instead of falling back."""
    if fn == "quantize":
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
