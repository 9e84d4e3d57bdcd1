"""The port's variadic Sum/Mean, GlobalMaxPool, Hardmax, Shrink,
EyeLike/CastLike, the host-only NonZero/Compress/Unique, the bit ops,
LpNormalization and ReverseSequence held against the JAX package's (the
counterpart of ``tests/test_more_ops2.py``), and the data-dependent ops
raising on device data where JAX's raise.

Float outputs are within rtol 2e-6 / atol 1e-6 (TOL); integer and
data-movement outputs are equal."""
import numpy as np
import pytest
import torch

from numpy_quant_tpu_torch import onnx as O

from .torch_parity import check, graph, port_model

TOL = dict(rtol=2e-6, atol=1e-6)
RNG = np.random.default_rng(47)


def test_sum_mean_variadic_and_global_max_pool():
    a = RNG.normal(size=(3, 4)).astype(np.float32)
    b = RNG.normal(size=(3, 4)).astype(np.float32)
    c = RNG.normal(size=(1, 4)).astype(np.float32)
    check([O.make_node("Sum", ["a", "b", "c"], ["s"]),
           O.make_node("Mean", ["a", "b", "c"], ["m"])],
          {"a": a, "b": b, "c": c}, outs=["s", "m"])
    x = RNG.normal(size=(2, 3, 5, 7)).astype(np.float32)
    got = check([O.make_node("GlobalMaxPool", ["x"], ["y"])], {"x": x})
    np.testing.assert_array_equal(got["y"], x.max(axis=(2, 3), keepdims=True))


@pytest.mark.parametrize("axis", [-1, 0])
def test_hardmax_with_ties(axis):
    x = RNG.normal(size=(4, 6)).astype(np.float32)
    x[1, 2] = x[1, 4] = x[1].max() + 1  # the first maximum wins
    check([O.make_node("Hardmax", ["x"], ["y"], axis=axis)], {"x": x})


def test_shrink_and_torch_oracles():
    x = (RNG.normal(size=(3, 7)) * 2).astype(np.float32)
    got = check([O.make_node("Shrink", ["x"], ["hard"], lambd=0.5, bias=0.0),
                 O.make_node("Shrink", ["x"], ["soft"], lambd=0.5, bias=0.5)],
                {"x": x}, outs=["hard", "soft"])
    tx = torch.tensor(x)
    np.testing.assert_array_equal(
        got["hard"], torch.nn.functional.hardshrink(tx, 0.5).numpy())
    np.testing.assert_allclose(
        got["soft"], torch.nn.functional.softshrink(tx, 0.5).numpy())


def test_eyelike_and_castlike():
    x = RNG.normal(size=(3, 5)).astype(np.float32)
    nodes = [O.make_node("EyeLike", ["x"], ["eye"]),
             O.make_node("EyeLike", ["x"], ["eye_k"], k=1),
             O.make_node("EyeLike", ["x"], ["eye_i"], dtype=7),
             O.make_node("CastLike", ["xi", "x"], ["as_f"])]
    got = check(nodes, {"x": x, "xi": np.array([1, 2], np.int64)},
                outs=["eye", "eye_k", "eye_i", "as_f"])
    np.testing.assert_array_equal(got["eye_k"], np.eye(3, 5, k=1))


def test_nonzero_compress_fold_on_host():
    xi = np.array([0, 3, 0, 5, 7, 0], np.int64)
    x = RNG.normal(size=(6, 4)).astype(np.float32)
    nodes = [O.make_node("NonZero", ["xi"], ["nz"]),
             O.make_node("Compress", ["x", "cond"], ["picked"], axis=0),
             O.make_node("Compress", ["x", "cond2"], ["flat"]),
             O.make_node("Compress", ["xi", "cond"], ["ipicked"], axis=0)]
    got = check(nodes, {"xi": xi, "x": x},
                [O.from_array((xi != 0).astype(np.int64), "cond"),
                 O.from_array(np.array([1, 0, 1], np.int64), "cond2")],
                ["nz", "picked", "flat", "ipicked"])
    np.testing.assert_array_equal(got["nz"], [[1, 3, 4]])
    np.testing.assert_array_equal(got["picked"], x[[1, 3, 4]])


@pytest.mark.parametrize("sorted_", [1, 0])
def test_unique_sorted_and_first_occurrence(sorted_):
    xi = np.array([2, 1, 1, 3, 4, 3], np.int64)
    got = check([O.make_node("Unique", ["xi"], ["y", "idx", "inv", "cnt"],
                             sorted=sorted_)],
                {"xi": xi}, outs=["y", "idx", "inv", "cnt"])
    np.testing.assert_array_equal(got["y"][got["inv"]], xi)
    np.testing.assert_array_equal(
        got["y"], [1, 2, 3, 4] if sorted_ else [2, 1, 3, 4])


def test_unique_along_an_axis():
    xi = np.array([[1, 0], [1, 0], [2, 3]], np.int64)
    check([O.make_node("Unique", ["xi"], ["y", "idx", "inv", "cnt"],
                       axis=0, sorted=0)],
          {"xi": xi}, outs=["y", "idx", "inv", "cnt"])


def test_bit_ops_host_and_device():
    a = np.array([0b1100, 0b1010, 7], np.int64)
    b = np.array([0b1010, 0b0110, 2], np.int64)
    ops = [("BitwiseAnd", {}), ("BitwiseOr", {}), ("BitwiseXor", {}),
           ("BitShift", {"direction": "LEFT"}),
           ("BitShift", {"direction": "RIGHT"})]
    nodes = [O.make_node(op, ["a", "b"], [f"h{i}"], **kw)
             for i, (op, kw) in enumerate(ops)]
    nodes.append(O.make_node("BitwiseNot", ["a"], ["hnot"]))
    got = check(nodes, {"a": a, "b": b}, outs=[n.output[0] for n in nodes])
    np.testing.assert_array_equal(got["h3"], a << b)
    # device integers (ArgMax) against host ones
    x = RNG.normal(size=(3, 8)).astype(np.float32)
    dnodes = [O.make_node("ArgMax", ["x"], ["i"], axis=1, keepdims=0)]
    dnodes += [O.make_node(op, ["i", "b"], [f"d{j}"], **kw)
               for j, (op, kw) in enumerate(ops)]
    dnodes.append(O.make_node("BitwiseNot", ["i"], ["dnot"]))
    check(dnodes, {"x": x, "b": b}, outs=[n.output[0] for n in dnodes[1:]])


def test_lp_normalization():
    x = RNG.normal(size=(4, 6)).astype(np.float32)
    check([O.make_node("LpNormalization", ["x"], ["l2"], axis=-1),
           O.make_node("LpNormalization", ["x"], ["l1"], axis=0, p=1)],
          {"x": x}, outs=["l2", "l1"], **TOL)


@pytest.mark.parametrize("time_axis,batch_axis,shape", [
    (0, 1, (5, 3, 2)), (1, 0, (3, 5, 2))])
def test_reverse_sequence_both_layouts(time_axis, batch_axis, shape):
    x = RNG.normal(size=shape).astype(np.float32)
    lens = np.array([5, 3, 1], np.int64)
    node = O.make_node("ReverseSequence", ["x", "lens"], ["y"],
                       time_axis=time_axis, batch_axis=batch_axis)
    check([node], {"x": x, "lens": lens})
    check([node], {"x": np.arange(30, dtype=np.int64).reshape(shape),
                   "lens": lens})


@pytest.mark.parametrize("op,extra", [
    ("NonZero", []), ("Unique", []),
    ("Compress", ["x"]), ("ReverseSequence", ["x"])])
def test_data_dependent_ops_refuse_device_data(op, extra):
    # the data-dependent operand is a device mask, as in JAX a traced
    # value: the op raises instead of reading it back
    x = RNG.normal(size=(4, 4)).astype(np.float32)
    ins = ["x", "m"] if extra else ["m"]
    outs = ["y", "i", "v", "c"] if op == "Unique" else ["y"]
    nodes = [O.make_node("Greater", ["x", "zero"], ["m"]),
             O.make_node(op, ins, outs)]
    model = port_model(graph(nodes, {"x": x},
                             [O.from_array(np.float32(0.0), "zero")], outs))
    with pytest.raises(ValueError, match="host-resident"):
        model([x])
