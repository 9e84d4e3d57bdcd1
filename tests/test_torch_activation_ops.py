"""The port's activation and utility ops (LeakyRelu, Elu, Selu, Softplus,
Softsign, HardSigmoid, HardSwish, Mish, PRelu, Celu, ThresholdedRelu,
Tile, Range, CumSum, Trilu, OneHot, Einsum) held against the JAX
package's on the same graphs and seeded inputs, in both tensor domains
(the counterpart of ``tests/test_activation_ops.py``).

Elementwise formulas are JAX's expressions; the transcendental functions
differ between XLA's and torch's CPU code by a few ulps, so float outputs
are held within rtol 2e-6 / atol 1e-6 (TOL). Data movement and integer
results are equal."""
import numpy as np
import pytest
import torch

from numpy_quant_tpu.ops.registry import \
    onnx_operator_implementation as jax_op
from numpy_quant_tpu.tensor import FTensor as JF, ITensor as JI
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.ops.registry import onnx_operator_implementation
from numpy_quant_tpu_torch.tensor import DITensor, FTensor, ITensor

from .torch_parity import check

TOL = dict(rtol=2e-6, atol=1e-6)
RNG = np.random.default_rng(11)


def test_activations_match_jax_and_torch():
    x = (RNG.standard_normal((3, 7)) * 2).astype(np.float32)
    x[0, :3] = (0.0, -0.0, 25.0)  # zero signs, softplus past torch's 20
    slope = np.abs(RNG.standard_normal(7)).astype(np.float32)
    nodes = [
        O.make_node("LeakyRelu", ["x"], ["leaky"], alpha=0.05),
        O.make_node("Elu", ["x"], ["elu"], alpha=0.7),
        O.make_node("Selu", ["x"], ["selu"]),
        O.make_node("Softplus", ["x"], ["softplus"]),
        O.make_node("Softsign", ["x"], ["softsign"]),
        O.make_node("HardSigmoid", ["x"], ["hardsig"], alpha=1 / 6, beta=0.5),
        O.make_node("HardSwish", ["x"], ["hardswish"]),
        O.make_node("Mish", ["x"], ["mish"]),
        O.make_node("PRelu", ["x", "slope"], ["prelu"]),
        O.make_node("Celu", ["x"], ["celu"], alpha=1.3),
        O.make_node("ThresholdedRelu", ["x"], ["thr"], alpha=1.0),
    ]
    names = [n.output[0] for n in nodes]
    got = check(nodes, {"x": x}, [O.from_array(slope, "slope")], names,
                **TOL)
    t = torch.tensor(x)
    F = torch.nn.functional
    oracle = {"leaky": F.leaky_relu(t, 0.05), "elu": F.elu(t, 0.7),
              "selu": F.selu(t), "softplus": F.softplus(t, threshold=100),
              "softsign": F.softsign(t), "hardsig": F.hardsigmoid(t),
              "hardswish": F.hardswish(t), "mish": F.mish(t),
              "prelu": F.prelu(t, torch.tensor(slope)),
              "celu": F.celu(t, 1.3), "thr": F.threshold(t, 1.0, 0.0)}
    for name in names:
        np.testing.assert_allclose(got[name], oracle[name].numpy(),
                                   atol=1e-5, err_msg=name)


def test_tile_range_cumsum_float():
    x = RNG.standard_normal((2, 3)).astype(np.float32)
    nodes = [O.make_node("Tile", ["x", "reps"], ["tiled"]),
             O.make_node("CumSum", ["x", "ax1"], ["csum"]),
             O.make_node("CumSum", ["x", "ax1"], ["csum_er"], exclusive=1,
                         reverse=1),
             O.make_node("Range", ["r0", "r1", "r2"], ["rng"])]
    inits = [O.from_array(np.array([2, 3], np.int64), "reps"),
             O.from_array(np.array(1, np.int64), "ax1"),
             O.from_array(np.array(1.0, np.float32), "r0"),
             O.from_array(np.array(5.5, np.float32), "r1"),
             O.from_array(np.array(1.5, np.float32), "r2")]
    got = check(nodes, {"x": x}, inits, ["tiled", "csum", "csum_er", "rng"],
                **TOL)
    np.testing.assert_array_equal(got["tiled"], np.tile(x, (2, 3)))
    np.testing.assert_array_equal(got["rng"],
                                  np.arange(1.0, 5.5, 1.5, dtype=np.float32))


@pytest.mark.parametrize("op,ins,attrs", [
    ("Tile", [np.array([[1, 2], [3, 4]]), np.array([2, 1])], {}),
    ("Range", [np.array(2), np.array(9), np.array(3)], {}),
    ("CumSum", [np.array([[1, 2], [3, 4]]), np.array(0)], {}),
    ("CumSum", [np.array([[1, 2], [3, 4]]), np.array(1)],
     {"exclusive": 1, "reverse": 1}),
    ("Trilu", [np.array([[1, 2], [3, 4]]), np.array(0)], {"upper": 1}),
    ("Trilu", [np.array([[1, 2], [3, 4]]), np.array(-1)], {"upper": 0}),
    ("OneHot", [np.array([0, 2, -1]), np.array(3), np.array([0, 1])],
     {"axis": -1}),
    ("OneHot", [np.array([[0, 2]]), np.array(3), np.array([5, 9])],
     {"axis": 0}),
])
def test_host_domain_stays_host(op, ins, attrs):
    out, = onnx_operator_implementation(op, [ITensor(a) for a in ins], attrs)
    want, = jax_op(op, [JI(a) for a in ins], attrs)
    assert isinstance(out, ITensor)
    np.testing.assert_array_equal(out.data, want.data)


def test_onehot_float_values_on_host_indices():
    vals = np.array([-1.0, 7.0], np.float32)
    out, = onnx_operator_implementation(
        "OneHot", [ITensor(np.array([1, 0])), ITensor(np.array(2)),
                   FTensor(torch.tensor(vals))], {})
    want, = jax_op("OneHot", [JI(np.array([1, 0])), JI(np.array(2)),
                              JF(vals)], {})
    assert isinstance(out, FTensor)
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(want.data))


def test_trilu_float_and_onehot_of_device_indices():
    x = RNG.standard_normal((4, 4)).astype(np.float32)
    nodes = [O.make_node("Trilu", ["x"], ["up"], upper=1),
             O.make_node("Trilu", ["x", "km1"], ["lo"], upper=0),
             O.make_node("ArgMax", ["x"], ["ids"], axis=1, keepdims=0),
             O.make_node("OneHot", ["ids", "depth", "vals"], ["oh"], axis=0),
             O.make_node("OneHot", ["ids", "depth", "ivals"], ["ioh"]),
             O.make_node("CumSum", ["ids", "ax0"], ["icum"])]
    inits = [O.from_array(np.array(-1, np.int64), "km1"),
             O.from_array(np.array(4, np.int64), "depth"),
             O.from_array(np.array([0.0, 1.0], np.float32), "vals"),
             O.from_array(np.array([3, 8], np.int64), "ivals"),
             O.from_array(np.array(0, np.int64), "ax0")]
    got = check(nodes, {"x": x}, inits, ["up", "lo", "oh", "ioh", "icum"])
    np.testing.assert_array_equal(got["up"], np.triu(x))
    ids = x.argmax(1)
    np.testing.assert_array_equal(got["icum"], np.cumsum(ids))


def test_device_integers_keep_their_domain():
    ids = DITensor(torch.tensor([[2, 0], [1, 3]], dtype=torch.int32))
    for op, extra in (("Tile", [ITensor(np.array([1, 2]))]),
                      ("Trilu", []),
                      ("CumSum", [ITensor(np.array(1))])):
        out, = onnx_operator_implementation(op, [ids] + extra, {})
        assert isinstance(out, DITensor) and out.data.dtype == torch.int32


@pytest.mark.parametrize("eq,shapes", [
    ("bij,jk->bik", [(3, 4, 5), (5, 6)]),
    ("bij->bji", [(3, 4, 5)]),
    ("ii->i", [(4, 4)]),
    ("bhqd,bhkd->bhqk", [(2, 3, 4, 8), (2, 3, 5, 8)]),
])
def test_einsum(eq, shapes):
    feeds = {f"a{i}": RNG.standard_normal(s).astype(np.float32)
             for i, s in enumerate(shapes)}
    got = check([O.make_node("Einsum", list(feeds), ["y"], equation=eq)],
                feeds, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["y"], np.einsum(eq, *feeds.values()),
                               rtol=1e-5, atol=1e-5)
