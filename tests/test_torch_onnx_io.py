"""The port's ONNX serialization layer (``numpy_quant_tpu_torch/onnx``)
against the JAX package's (the counterpart of ``tests/test_onnx_io.py``):
the same graph functions write the same bytes, a model parsed by either reads
back the same fields, GraphProto attributes (If/Loop bodies) survive a
round trip and run, external-data files load, and the op coverage of the
registry is the JAX package's."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.ops.registry import onnx_operator_implementation
from numpy_quant_tpu_torch.tensor import QTensor

from .torch_parity import FLOAT, graph, jax_model, port_model, run_jax

RNG = np.random.default_rng(3)


def _model():
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    inp = O.make_tensor_value_info("x", FLOAT, [2, 3])
    out = O.make_tensor_value_info("y", FLOAT, ["B", 4])
    nodes = [O.make_node("MatMul", ["x", "w"], ["h"], name="mm"),
             O.make_node("Gemm", ["h", "w", "b"], ["y"], name="gm",
                         alpha=1.0, transB=1, pads=[0, 1, 2, 3],
                         mode="constant")]
    g = O.make_graph(nodes, "g", [inp], [out],
                     initializer=[O.from_array(w, "w"),
                                  O.from_array(np.ones(4, np.int64), "b")])
    return O.make_model(g, opset_imports=[O.make_opsetid("", 17)])


def test_round_trip_bytes_equal_jax():
    m = _model()
    data = m.SerializeToString()
    assert nq.onnx.load_from_string(data).SerializeToString() == data
    m2 = O.load_from_string(data)
    attrs = {a.name: O.get_attribute_value(a) for a in m2.graph.node[1].attribute}
    assert attrs["pads"] == [0, 1, 2, 3] and attrs["mode"] == b"constant"
    assert O.value_info_shape(m2.graph.output[0]) == ("B", 4)
    assert m2.SerializeToString() == data


def test_negative_ints_and_large_varints():
    t = O.from_array(np.array([-1, -(2 ** 40), 2 ** 40], np.int64), "t")
    n = O.make_node("Slice", ["x"], ["y"], starts=[-1, 0], ends=[-(2 ** 31)])
    m = O.make_model(O.make_graph([n], "g", [], [], initializer=[t]))
    data = m.SerializeToString()
    assert nq.onnx.load_from_string(data).SerializeToString() == data
    attrs = {a.name: O.get_attribute_value(a)
             for a in O.load_from_string(data).graph.node[0].attribute}
    assert attrs["ends"] == [-(2 ** 31)]


def test_graph_attributes_round_trip_and_run():
    then_g = O.make_graph([O.make_node("Neg", ["x"], ["ty"])], "t", [],
                          [O.make_tensor_value_info("ty", FLOAT, None)])
    else_g = O.make_graph([O.make_node("Abs", ["x"], ["ey"])], "e", [],
                          [O.make_tensor_value_info("ey", FLOAT, None)])
    x = RNG.normal(size=(2, 3)).astype(np.float32)
    proto = graph([O.make_node("If", ["c"], ["y"], then_branch=then_g,
                               else_branch=else_g)], {"x": x},
                  [O.from_array(np.array(False), "c")])
    parsed = O.load_from_string(proto.SerializeToString())
    bodies = {a.name: O.get_attribute_value(a)
              for a in parsed.graph.node[0].attribute}
    assert isinstance(bodies["else_branch"], O.GraphProto)
    assert bodies["else_branch"].node[0].op_type == "Abs"
    got = port_model(parsed)([x])[0]
    np.testing.assert_array_equal(got, run_jax(jax_model(parsed), [x])[0])
    np.testing.assert_array_equal(got, np.abs(x))


def test_external_data_round_trip(tmp_path):
    big = RNG.normal(size=(64, 32)).astype(np.float32)
    x = RNG.normal(size=(4, 64)).astype(np.float32)
    m = graph([O.make_node("MatMul", ["x", "w"], ["h"]),
               O.make_node("Add", ["h", "b"], ["y"])], {"x": x},
              [O.from_array(big, "w"),
               O.from_array(RNG.normal(size=32).astype(np.float32), "b")])
    p = str(tmp_path / "ext.onnx")
    O.save(m, p, external_data_threshold=1024)
    assert Path(p + ".data").stat().st_size == big.nbytes
    loaded = O.load(p)
    assert loaded.SerializeToString() == nq.onnx.load(p).SerializeToString()
    want = port_model(m)([x])[0]
    np.testing.assert_array_equal(port_model(loaded)([x])[0], want)


def _jax_op_names():
    """Every op name the JAX registry dispatches: its literal branches and
    its float unary table."""
    src = Path(nq.__file__).parent.joinpath("ops", "registry.py").read_text()
    names = set(re.findall(r'op == "(\w+)"', src))
    for group in re.findall(r"op in \(([^)]*)\)", src):
        names |= set(re.findall(r'"(\w+)"', group))
    table = re.search(r"_UNARY_FLOAT_FNS = \{(.*?)\}", src, re.S).group(1)
    return names | set(re.findall(r'"(\w+)":', table))


# the ops this slice ported (JAX registry names the port raised
# NotImplementedError for), and the one name left out
PORTED = (
    "Abs Acos Acosh And ArgMax ArgMin Asin Asinh Atan Atanh AveragePool "
    "BatchNormalization BitShift BitwiseAnd BitwiseNot BitwiseOr BitwiseXor "
    "Ceil Celu Clip Compress ConvTranspose Cos Cosh CumSum DepthToSpace "
    "Einsum Elu Exp EyeLike Flatten Floor GatherElements GatherND Gelu "
    "GlobalAveragePool GlobalMaxPool Greater GreaterOrEqual "
    "GroupNormalization HardSigmoid HardSwish Hardmax InstanceNormalization "
    "IsInf IsNaN LeakyRelu Less LessOrEqual Log LogSoftmax LpNormalization "
    "Max MaxPool Mean Min Mish Mod NonZero Not OneHot Or PRelu Pad Pow Range "
    "Reciprocal ReduceL1 ReduceL2 ReduceLogSum ReduceLogSumExp ReduceMax "
    "ReduceMin ReduceProd ReduceSum ReduceSumSquare Resize ReverseSequence "
    "Round ScatterElements ScatterND Selu Shrink Sign Sin Sinh Softplus "
    "Softsign SpaceToDepth Squeeze Sub Sum Tan ThresholdedRelu Tile TopK "
    "Trilu Unique Xor").split()
# every op name the JAX package dispatches is dispatched
WAITING = ()


def test_registry_dispatches_every_jax_op():
    assert len(PORTED) == 99
    jax_names = _jax_op_names()
    assert set(PORTED) <= jax_names
    for op in sorted(jax_names - set(WAITING)):
        try:
            onnx_operator_implementation(op, [], {})
        except NotImplementedError:
            pytest.fail(f"{op} is not dispatched")
        except Exception:  # noqa: BLE001 -- dispatched, no inputs given
            pass
    # MatMulSplit (passes/matmul_merge.py's merged product) dispatches
    x = QTensor(torch.tensor([[1, 2]], dtype=torch.int32), 8,
                np.float32(0.5), None)
    w = QTensor(torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32), 8,
                np.float32(0.25), None)
    outs = onnx_operator_implementation(
        "MatMulSplit", [x, w], {"segments": [1, 2],
                                "segment_scales": [0.25, 0.25]})
    assert [o.data.tolist() for o in outs] == [[[9]], [[12, 15]]]
