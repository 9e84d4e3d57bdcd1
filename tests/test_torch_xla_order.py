"""XLA's CPU orders replayed on CPU tensors: the row sum
(``intops.xla_cpu_row_sum``), the float32 exp (``intops.xla_cpu_exp``) and
the batched dot of two activations (``ops/registry.py::_xla_cpu_dot``),
and the port's CPU LayerNorm, softmax and erf held to JAX's bit for bit.

XLA's CPU compiler rewrites a float reduce of n > 32 into windows of 32
(zero-padded, (32·⌈n/32⌉ − n) // 2 in front), each chained from 0, and
reduces the partials by the same rule; a mean multiplies by float32(1/n).
The replay equals ``jnp.sum``/``jnp.mean`` bit for bit on every row, eager
and jitted, over the last axis and others. ``FTensor.mean``/``sum`` take it
on float32 CPU tensors, ``FTensor.sqrt`` is IEEE there, so the port's
LayerNorm and ReduceMean nodes equal JAX's ops; the softmax takes XLA's
exp and row sums, the exact-form erf XLA's exp; other dtypes and devices,
and walks autograd tracks, keep torch's order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpy_quant_tpu.ops import registry as JOPS
from numpy_quant_tpu.tensor import FTensor as JFTensor
from numpy_quant_tpu.tensor import ITensor as JITensor
from numpy_quant_tpu_torch import config
from numpy_quant_tpu_torch.intops import (fma_f32, xla_cpu_exp,
                                          xla_cpu_row_sum)
from numpy_quant_tpu_torch.ops.erf import exact_erf
from numpy_quant_tpu_torch.ops.registry import (_ynn_lanes,
                                                onnx_operator_implementation)
from numpy_quant_tpu_torch.tensor import FTensor, ITensor
from .torch_parity import assert_mapped_xla_cpu_host

LENGTHS = (1, 31, 32, 33, 50, 128, 197, 768, 1025, 3072, 50257)


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def test_host_is_the_kind_the_orders_were_mapped_on():
    """The replays below are XLA's orders on jaxlib 0.9 and an AVX-512
    CPU; elsewhere this fails first and says so."""
    assert_mapped_xla_cpu_host()


def fma_f32_exact(a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """round_f32(a * b + c) of float32 tensors, one rounding, in float64
    steps: the float64 product is exact, the float64 sum is rounded to odd
    (a sticky last bit), and the odd-rounded sum rounds to float32 as the
    exact one would. The reference ``fma_f32`` is held to."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bp = s - c
    err = (c - (s - bp)) + (p - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


def _rows(n: int, rows: int = 24) -> np.ndarray:
    rng = np.random.default_rng(n)
    return (rng.standard_normal((rows, n)) * 3 + 0.5).astype(np.float32)


@pytest.mark.parametrize("n", LENGTHS)
def test_row_sum_and_mean_equal_jnp(n):
    a = _rows(n)
    s = xla_cpu_row_sum(torch.from_numpy(a), -1)
    m = s * torch.tensor(np.float32(1.0 / n))
    for f in (lambda v: v, jax.jit):
        np.testing.assert_array_equal(
            s.numpy(), np.asarray(f(lambda v: jnp.sum(v, axis=-1))(a)))
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(f(lambda v: jnp.mean(v, axis=-1))(a)))
    assert (FTensor(torch.from_numpy(a)).mean(-1, False).data.numpy()
            == m.numpy()).all()


@pytest.mark.parametrize("shape,axis", [((197, 64), 0), ((4, 197, 96), 1),
                                        ((3, 40, 5), 1), ((2, 3, 50, 50), 2)])
def test_other_axes_equal_jnp(shape, axis):
    a = (np.random.default_rng(1).standard_normal(shape) * 3 + 0.5) \
        .astype(np.float32)
    got = FTensor(torch.from_numpy(a)).sum(axis, True).data.numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.sum(a, axis=axis,
                                                          keepdims=True)))


@pytest.mark.parametrize("shape", [(4, 65, 128), (2, 197, 768)])
def test_layer_norm_node_equals_jax(shape):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(shape) * 0.7 + 0.1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    attrs = {"axis": -1, "epsilon": 1e-12}
    want = JOPS.onnx_operator_implementation(
        "LayerNormalization", [JFTensor(x), JFTensor(w), JFTensor(b)],
        attrs)[0]
    got = onnx_operator_implementation(
        "LayerNormalization", [FTensor(torch.from_numpy(x)),
                               FTensor(torch.from_numpy(w)),
                               FTensor(torch.from_numpy(b))], attrs)[0]
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def test_reduce_mean_node_equals_jax():
    x = (np.random.default_rng(2).standard_normal((3, 50, 40)) + 1) \
        .astype(np.float32)
    for axes in ([1], [-1], [0]):
        want = JOPS.onnx_operator_implementation(
            "ReduceMean", [JFTensor(x), JITensor(np.array(axes))],
            {"keepdims": 1})[0]
        got = onnx_operator_implementation(
            "ReduceMean", [FTensor(torch.from_numpy(x)),
                           ITensor(np.array(axes))], {"keepdims": 1})[0]
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(want.data))


def test_sqrt_is_ieee():
    a = np.exp(np.random.default_rng(3).uniform(-20, 5, 4096)) \
        .astype(np.float32)
    got = FTensor(torch.from_numpy(a)).sqrt().data.numpy()
    np.testing.assert_array_equal(got, np.sqrt(a))
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(a)))


def test_torch_order_kept_elsewhere():
    """The bf16 serving mode's tensors keep torch's order (the card's
    kernels replay it), and so does a float32 softmax that autograd tracks
    (QAT's walk, the trainers'): torch's ops, which it can differentiate;
    the untracked float32 CPU softmax is XLA's (below). A tensor on another
    device never reaches the replay."""
    a = _rows(197)
    with config.low_precision_floats():
        h = FTensor(torch.from_numpy(a))
        assert h.data.dtype == torch.bfloat16
        assert torch.equal(h.sum(-1, False).data, torch.sum(h.data, -1))
        assert torch.equal(h.mean(-1, False).data, torch.mean(h.data, -1))
        e = torch.exp(h.data - torch.amax(h.data, -1, keepdim=True))
        assert torch.equal(h.softmax(-1).data,
                           e / torch.sum(e, dim=-1, keepdim=True))
    t = FTensor(torch.from_numpy(a).requires_grad_())
    e = torch.exp(t.data - torch.amax(t.data, -1, keepdim=True))
    assert torch.equal(t.softmax(-1).data,
                       e / torch.sum(e, dim=-1, keepdim=True))
    with torch.no_grad():
        assert not torch.equal(t.softmax(-1).data,
                               e / torch.sum(e, dim=-1, keepdim=True))
    assert FTensor(torch.empty(2, 40, device="meta"))._xla_axis(-1) is None


def test_fused_multiply_add_is_one_rounding():
    """fma_f32 (torch's CPU addcmul) rounds a * b + c once, as the float64
    round-to-odd replay does, at vector and tail lengths and broadcast."""
    for n in (1, 7, 8, 17, 64, 100, 4099):
        g = torch.Generator().manual_seed(n)
        a, b = torch.randn(n, generator=g), torch.randn(n, generator=g)
        c = torch.randn(n, generator=g) * 1e-3
        assert torch.equal(fma_f32(a, b, c), fma_f32_exact(a, b, c))
        assert not torch.equal(c + a * b, fma_f32_exact(a, b, c)) or n < 8
    a, b, c = torch.randn(64, 1), torch.randn(1, 48), torch.randn(64, 48)
    assert torch.equal(fma_f32(a, b, c), fma_f32_exact(a, b, c))


def test_exp_equals_xla():
    """XLA's CPU float32 exp, replayed: every value over the range that
    neither underflows nor overflows, the flush below 2^-126 to 0, the
    overflow to inf, infinities and NaN."""
    rng = np.random.default_rng(8)
    x = np.concatenate([
        rng.uniform(-110, 95, 200_000), rng.uniform(-1, 1, 50_000),
        np.linspace(-87.34, -87.33, 2001), np.linspace(88.6, 88.8, 2001),
        [-np.inf, np.inf, np.nan, 0.0, -0.0, 1e-30, -1e-30, 3e38, -3e38]]
    ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = xla_cpu_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == np.exp(x.astype(np.float64)).astype(np.float32)).mean() \
        < 0.95          # XLA's exp is not the correctly rounded one


@pytest.mark.parametrize("shape", [(4, 65, 65), (2, 3, 17, 300),
                                   (8, 1, 1, 2049)])
def test_softmax_equals_jax(shape):
    """The float32 CPU softmax (XLA's exp and row-sum order) equals the
    JAX package's op bit for bit, eager and inside a jitted program."""
    s = (np.random.default_rng(len(shape)).standard_normal(shape) * 4) \
        .astype(np.float32)
    want = np.asarray(JFTensor(jnp.asarray(s)).softmax(-1)._data)
    got = FTensor(torch.from_numpy(s)).softmax(-1).data.numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax.jit(
        lambda v: JFTensor(v).softmax(-1)._data)(s)))


def test_erf_equals_jax():
    """The exact-form erf on float32 CPU tensors (its exp XLA's) equals the
    JAX package's float-path erf bit for bit."""
    x = np.random.default_rng(9).uniform(-5, 5, 100_000).astype(np.float32)
    want = np.asarray(JFTensor(jnp.asarray(x)).erf()._data)
    np.testing.assert_array_equal(
        exact_erf(torch.from_numpy(x)).numpy(), want)


# (m, k, n): XLA hands a float32 dot to YNNPACK where it has more than 50
# rows or at most 16 columns: k lanes 4 (n not a multiple of 32), 2
# (n % 64 == 32) or 1 (n % 64 == 0); elsewhere Eigen's one chain (the
# replay starts at k = 11)
DOTS = [(65, 32, 65), (65, 65, 32), (17, 16, 17), (17, 64, 17), (60, 35, 17),
        (64, 34, 48), (70, 67, 96), (51, 32, 17), (50, 32, 17), (8, 20, 8),
        (64, 32, 64), (2, 40, 16), (2, 40, 17), (66, 11, 130)]


@pytest.mark.parametrize("m,k,n", DOTS)
def test_batched_dot_equals_xla(m, k, n):
    """The batched float32 product of two activations (attention's scores
    and context) sums in XLA's CPU order where the rule says YNNPACK takes
    it, and equals jnp.matmul bit for bit; elsewhere torch's (Eigen's order
    and torch's agree at these depths)."""
    rng = np.random.default_rng(m * k * n)
    a = rng.standard_normal((2, 3, m, k)).astype(np.float32)
    b = rng.standard_normal((2, 3, k, n)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.matmul)(a, b))
    got = onnx_operator_implementation(
        "MatMul", [FTensor(torch.from_numpy(a)),
                   FTensor(torch.from_numpy(b))], {})[0]
    np.testing.assert_array_equal(got.data.numpy(), want)
    lanes = _ynn_lanes(m, k, n)
    assert lanes == (0 if m <= 50 and n > 16 else
                     4 if n % 32 else 2 if n % 64 else 1)
