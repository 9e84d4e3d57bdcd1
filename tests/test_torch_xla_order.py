"""XLA's CPU row-sum order replayed on CPU tensors
(``intops.xla_cpu_row_sum``), and the port's CPU LayerNorm held to JAX's
bit for bit.

XLA's CPU compiler rewrites a float reduce of n > 32 into windows of 32
(zero-padded, (32·⌈n/32⌉ − n) // 2 in front), each chained from 0, and
reduces the partials by the same rule; a mean multiplies by float32(1/n).
The replay equals ``jnp.sum``/``jnp.mean`` bit for bit on every row, eager
and jitted, over the last axis and others. ``FTensor.mean``/``sum`` take it
on float32 CPU tensors, ``FTensor.sqrt`` is IEEE there, so the port's
LayerNorm and ReduceMean nodes equal JAX's ops; other dtypes and devices,
and the softmax row sums, keep torch's order.
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
from numpy_quant_tpu_torch.intops import xla_cpu_row_sum
from numpy_quant_tpu_torch.ops.registry import onnx_operator_implementation
from numpy_quant_tpu_torch.tensor import FTensor, ITensor

LENGTHS = (1, 31, 32, 33, 50, 128, 197, 768, 1025, 3072, 50257)


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


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
    """The bf16 serving mode's tensors and the softmax row sums keep torch's
    order (the card's kernels and the plain attention versions replay it);
    a tensor on another device never reaches the replay."""
    a = _rows(197)
    with config.low_precision_floats():
        h = FTensor(torch.from_numpy(a))
        assert h.data.dtype == torch.bfloat16
        assert torch.equal(h.sum(-1, False).data, torch.sum(h.data, -1))
        assert torch.equal(h.mean(-1, False).data, torch.mean(h.data, -1))
    t = FTensor(torch.from_numpy(a))
    e = torch.exp(t.data - torch.amax(t.data, -1, keepdim=True))
    assert torch.equal(t.softmax(-1).data,
                       e / torch.sum(e, dim=-1, keepdim=True))
    assert FTensor(torch.empty(2, 40, device="meta"))._xla_axis(-1) is None
