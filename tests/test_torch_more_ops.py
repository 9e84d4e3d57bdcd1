"""The port's elementwise math (the float-only unary table, Abs, Sign,
Round, Sub, Pow, Mod, Clip), comparisons and logic (DITensor masks),
IsNaN/IsInf, LogSoftmax, the Reduce family, Flatten, GatherND,
ScatterND and DepthToSpace/SpaceToDepth held against the JAX package's
on the same graphs (the counterpart of ``tests/test_more_ops.py``).

Transcendental outputs are held within rtol 2e-6 / atol 1e-6 (TOL:
XLA's and torch's CPU math differ by a few ulps), reductions within
rtol 1e-5 (their summation orders differ); integer, mask, rounding and
data-movement outputs are equal, dtype included."""
import numpy as np
import pytest
import torch

from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.ops.registry import onnx_operator_implementation
from numpy_quant_tpu_torch.tensor import FTensor, ITensor

from .torch_parity import check

TOL = dict(rtol=2e-6, atol=1e-6)
RNG = np.random.default_rng(23)


def test_unary_float_table_and_rounding():
    x = np.clip(RNG.standard_normal((3, 5)) * 0.8, -0.95, 0.95) \
        .astype(np.float32)
    xp = np.abs(x) + 0.1
    xa = (np.abs(RNG.standard_normal((3, 5))) + 1.0).astype(np.float32)
    ops_x = ["Exp", "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh",
             "Cosh", "Asinh", "Atanh", "Floor", "Ceil", "Round", "Sign",
             "Abs", "Neg"]
    nodes = [O.make_node(op, ["x"], [op.lower()]) for op in ops_x]
    nodes += [O.make_node("Log", ["xp"], ["log"]),
              O.make_node("Reciprocal", ["xp"], ["reciprocal"]),
              O.make_node("Acosh", ["xa"], ["acosh"])]
    outs = [n.output[0] for n in nodes]
    got = check(nodes, {"x": x, "xp": xp, "xa": xa}, outs=outs, **TOL)
    np.testing.assert_allclose(got["atanh"], np.arctanh(x), rtol=1e-5)


def test_round_half_to_even():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.675], np.float32)
    got = check([O.make_node("Round", ["x"], ["y"])], {"x": x})
    np.testing.assert_array_equal(got["y"], [0.0, 2.0, 2.0, -0.0, -2.0, 3.0])


def test_sub_pow_clip_float_and_host():
    a = RNG.standard_normal((3, 4)).astype(np.float32)
    b = RNG.standard_normal((3, 4)).astype(np.float32)
    nodes = [O.make_node("Sub", ["a", "b"], ["sub"]),
             O.make_node("Pow", ["a", "two"], ["pow"]),
             O.make_node("Pow", ["a", "itwo"], ["ipow"]),
             O.make_node("Clip", ["a", "lo", "hi"], ["clip"]),
             O.make_node("Clip", ["a", "", "hi"], ["cliphi"]),
             O.make_node("Shape", ["a"], ["shp"]),
             O.make_node("Sub", ["shp", "one"], ["shp1"]),
             O.make_node("Clip", ["shp", "ione", "ithree"], ["shpc"])]
    inits = [O.from_array(np.float32(2.0), "two"),
             O.from_array(np.int64(2), "itwo"),
             O.from_array(np.float32(-0.5), "lo"),
             O.from_array(np.float32(0.5), "hi"),
             O.from_array(np.array([1, 1], np.int64), "one"),
             O.from_array(np.int64(1), "ione"),
             O.from_array(np.int64(3), "ithree")]
    got = check(nodes, {"a": a, "b": b}, inits,
                ["sub", "pow", "ipow", "clip", "cliphi", "shp1", "shpc"],
                **TOL)
    np.testing.assert_array_equal(got["sub"], a - b)
    np.testing.assert_array_equal(got["shp1"], [2, 3])
    np.testing.assert_array_equal(got["shpc"], [3, 3])


def test_comparisons_logic_and_masks():
    a = RNG.standard_normal((4, 5)).astype(np.float32)
    b = RNG.standard_normal((4, 5)).astype(np.float32)
    b[1] = a[1]
    ops = ["Greater", "Less", "GreaterOrEqual", "LessOrEqual"]
    nodes = [O.make_node(op, ["a", "b"], [op.lower()]) for op in ops]
    nodes += [O.make_node("And", ["greater", "lessorequal"], ["and_"]),
              O.make_node("Or", ["greater", "less"], ["or_"]),
              O.make_node("Xor", ["greater", "greaterorequal"], ["xor_"]),
              O.make_node("Not", ["less"], ["not_"]),
              O.make_node("Greater", ["a", "zero"], ["mask"]),
              O.make_node("Where", ["mask", "a", "zero"], ["relu"])]
    got = check(nodes, {"a": a, "b": b},
                [O.from_array(np.zeros((4, 5), np.float32), "zero")],
                [n.output[0] for n in nodes])
    np.testing.assert_array_equal(got["greater"], (a > b).astype(np.int32))
    np.testing.assert_array_equal(got["relu"], np.maximum(a, 0.0))


def test_comparisons_and_logic_fold_on_host():
    a = np.array([1, 5, 3, 0], np.int64)
    b = np.array([2, 5, 1, 1], np.int64)
    ops = ["Greater", "Less", "GreaterOrEqual", "LessOrEqual", "And", "Or",
           "Xor"]
    nodes = [O.make_node(op, ["a", "b"], [op.lower()]) for op in ops]
    nodes.append(O.make_node("Not", ["a"], ["not_"]))
    got = check(nodes, {"a": a, "b": b}, outs=[n.output[0] for n in nodes])
    assert got["greater"].dtype == np.int64
    np.testing.assert_array_equal(got["and"], [1, 1, 1, 0])


def test_isnan_isinf():
    x = np.array([1.0, np.nan, np.inf, -np.inf, 0.0], np.float32)
    nodes = [O.make_node("IsNaN", ["x"], ["nan"]),
             O.make_node("IsInf", ["x"], ["inf"]),
             O.make_node("IsInf", ["x"], ["posinf"], detect_negative=0),
             O.make_node("IsInf", ["x"], ["neginf"], detect_positive=0)]
    got = check(nodes, {"x": x}, outs=["nan", "inf", "posinf", "neginf"])
    np.testing.assert_array_equal(got["neginf"], [0, 0, 0, 1, 0])


@pytest.mark.parametrize("fmod", [0, 1])
def test_mod_host_and_device(fmod):
    a = np.array([5, -5, 7, -7, 0], np.int64)
    b = np.array([3, 3, -4, -4, 2], np.int64)
    got = check([O.make_node("Mod", ["a", "b"], ["m"], fmod=fmod)],
                {"a": a, "b": b}, outs=["m"])
    np.testing.assert_array_equal(got["m"], np.fmod(a, b) if fmod
                                  else np.mod(a, b))
    af = np.array([5.1, -5.1, 7.5, -7.5], np.float32)
    bf = np.array([3.0, 3.0, -4.0, -4.0], np.float32)
    check([O.make_node("Mod", ["a", "b"], ["m"], fmod=fmod)],
          {"a": af, "b": bf}, outs=["m"], **TOL)


def test_mod_of_device_integers():
    x = RNG.standard_normal((3, 6)).astype(np.float32)
    nodes = [O.make_node("ArgMax", ["x"], ["i"], axis=1),
             O.make_node("Mod", ["i", "four"], ["m"]),
             O.make_node("Mod", ["i", "mthree"], ["mm"], fmod=1)]
    check(nodes, {"x": x}, [O.from_array(np.int64(4), "four"),
                            O.from_array(np.int64(-3), "mthree")],
          ["m", "mm"])


def test_logsoftmax():
    x = (RNG.standard_normal((4, 9)) * 4).astype(np.float32)
    got = check([O.make_node("LogSoftmax", ["x"], ["y"], axis=-1),
                 O.make_node("LogSoftmax", ["x"], ["y0"], axis=0)],
                {"x": x}, outs=["y", "y0"], **TOL)
    np.testing.assert_allclose(
        got["y"], torch.log_softmax(torch.tensor(x), -1).numpy(), atol=1e-5)


@pytest.mark.parametrize("keepdims", [0, 1])
def test_reduce_family(keepdims):
    x = (np.abs(RNG.standard_normal((3, 4, 5))) + 0.1).astype(np.float32)
    ops = ["ReduceProd", "ReduceL1", "ReduceL2", "ReduceSumSquare",
           "ReduceLogSum", "ReduceLogSumExp", "ReduceSum", "ReduceMax",
           "ReduceMin"]
    nodes = [O.make_node(op, ["x"], [op.lower()], axes=[1],
                         keepdims=keepdims) for op in ops]
    nodes += [O.make_node(op, ["x", "ax"], [op.lower() + "_in"],
                          keepdims=keepdims) for op in ops]
    nodes += [O.make_node(op, ["x"], [op.lower() + "_all"],
                          keepdims=keepdims) for op in ops]
    got = check(nodes, {"x": x},
                [O.from_array(np.array([0, 2], np.int64), "ax")],
                [n.output[0] for n in nodes], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["reducelogsumexp"], np.log(np.sum(
        np.exp(x.astype(np.float64)), 1, keepdims=bool(keepdims))),
        rtol=1e-5)


@pytest.mark.parametrize("op", ["ReduceProd", "ReduceL1", "ReduceSumSquare",
                                "ReduceSum", "ReduceMax", "ReduceMin"])
def test_reduce_host_fold(op):
    x = RNG.standard_normal((2, 3, 4)).astype(np.float32)
    nodes = [O.make_node("Shape", ["x"], ["shape"]),
             O.make_node(op, ["shape"], ["r"], axes=[0], keepdims=1),
             O.make_node("Mul", ["r", "one"], ["y"])]
    got = check(nodes, {"x": x}, [O.from_array(np.array([1], np.int64),
                                               "one")])
    assert got["y"].dtype == np.int64


def test_flatten_feeds_reshape_and_logsumexp_of_inf():
    x = RNG.standard_normal((2, 3, 4)).astype(np.float32)
    x[0, 0, 0] = -np.inf
    nodes = [O.make_node("Flatten", ["x"], ["f1"], axis=1),
             O.make_node("Flatten", ["x"], ["f0"], axis=0),
             O.make_node("Flatten", ["x"], ["f2"], axis=-1),
             O.make_node("ReduceLogSumExp", ["x"], ["lse"], axes=[2])]
    check(nodes, {"x": x}, outs=["f1", "f0", "f2", "lse"], **TOL)


@pytest.mark.parametrize("data,idx,batch_dims", [
    (np.array([[0, 1], [2, 3]]), np.array([[0, 0], [1, 1]]), 0),
    (np.array([[0, 1], [2, 3]]), np.array([[1], [0]]), 0),
    (np.arange(8).reshape(2, 2, 2), np.array([[0, 1], [1, 0]]), 0),
    (np.arange(8).reshape(2, 2, 2), np.array([[1], [0]]), 1),
    (np.arange(8).reshape(2, 2, 2), np.array([[-1, 0]]), 0),
])
def test_gather_nd_spec_examples(data, idx, batch_dims):
    check([O.make_node("GatherND", ["d", "i"], ["y"], batch_dims=batch_dims)],
          {"d": data.astype(np.int64), "i": idx.astype(np.int64)})


def test_gather_nd_float_and_device_indices():
    data = RNG.standard_normal((4, 5, 6)).astype(np.float32)
    idx = np.array([[0, 1], [3, 4], [2, 0]], np.int64)
    got = check([O.make_node("GatherND", ["d", "i"], ["y"])],
                {"d": data, "i": idx})
    np.testing.assert_array_equal(got["y"], data[idx[:, 0], idx[:, 1]])
    # indices from a device ArgMax
    x = RNG.standard_normal((3, 4)).astype(np.float32)
    check([O.make_node("ArgMax", ["x"], ["i"], axis=1),
           O.make_node("GatherND", ["t", "i"], ["y"])],
          {"x": x, "t": RNG.standard_normal((4, 2)).astype(np.float32)})


@pytest.mark.parametrize("reduction", ["none", "add", "mul", "max", "min"])
def test_scatter_nd(reduction):
    data = RNG.standard_normal((5, 3)).astype(np.float32)
    # a duplicate destination: updates apply in order
    idx = np.array([[1], [3], [1], [-1]], np.int64)
    upd = RNG.standard_normal((4, 3)).astype(np.float32)
    got = check([O.make_node("ScatterND", ["d", "i", "u"], ["y"],
                             reduction=reduction)],
                {"d": data, "u": upd}, [O.from_array(idx, "i")])
    if reduction == "add":
        want = data.copy()
        np.add.at(want, idx[:, 0], upd)
        np.testing.assert_allclose(got["y"], want, rtol=1e-6)


def test_scatter_nd_host_int():
    data = np.arange(8, dtype=np.int64)
    idx = np.array([[4], [3], [1], [7]], np.int64)
    upd = np.array([9, 10, 11, 12], np.int64)
    got = check([O.make_node("ScatterND", ["d", "i", "u"], ["y"])],
                {"d": data, "i": idx, "u": upd})
    np.testing.assert_array_equal(got["y"], [0, 11, 2, 10, 9, 5, 6, 12])


def test_scatter_nd_round_plan_is_kept_on_the_indices():
    idx = ITensor(np.array([[0], [0], [2]]))
    d = FTensor(torch.zeros(3, 2))
    u = FTensor(torch.ones(3, 2))
    a, = onnx_operator_implementation("ScatterND", [d, idx, u],
                                      {"reduction": "add"})
    plans = idx.__dict__["_plans"]
    assert len(plans) == 1 and len(next(iter(plans.values()))) == 2
    b, = onnx_operator_implementation("ScatterND", [d, idx, u],
                                      {"reduction": "add"})
    assert len(idx.__dict__["_plans"]) == 1
    np.testing.assert_array_equal(a.data.numpy(), [[2, 2], [0, 0], [1, 1]])
    np.testing.assert_array_equal(a.data.numpy(), b.data.numpy())


@pytest.mark.parametrize("op,attrs,shape", [
    ("DepthToSpace", {"blocksize": 2, "mode": "CRD"}, (2, 12, 3, 5)),
    ("DepthToSpace", {"blocksize": 2}, (2, 8, 4, 6)),
    ("SpaceToDepth", {"blocksize": 2}, (2, 3, 4, 6)),
])
def test_depth_space(op, attrs, shape):
    x = RNG.standard_normal(shape).astype(np.float32)
    got = check([O.make_node(op, ["x"], ["y"], **attrs)], {"x": x})
    if attrs.get("mode") == "CRD":
        np.testing.assert_array_equal(
            got["y"], torch.pixel_shuffle(torch.tensor(x), 2).numpy())
