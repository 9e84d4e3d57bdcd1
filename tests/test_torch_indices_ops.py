"""ArgMax/ArgMin/TopK and the device integer domain (DITensor) of the port
held against the JAX package's (the counterpart of
``tests/test_indices_ops.py``): values, tie orders (the first maximum;
``select_last_index``; TopK's lower index first and +0.0 above -0.0, as
``lax.top_k``) and the int32 dtype of the outputs are equal; TopK values
equal. Gather, Squeeze, Reshape and Tile carry DITensors as JAX's rules
do, and a device ``k`` raises."""
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import cnn as jcnn
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.models import cnn
from numpy_quant_tpu_torch.ops.registry import onnx_operator_implementation
from numpy_quant_tpu_torch.tensor import DITensor, FTensor, ITensor

from .torch_parity import check, run_jax

RNG = np.random.default_rng(3)


@pytest.mark.parametrize("keepdims", [0, 1])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_argmax_argmin(axis, keepdims):
    x = RNG.standard_normal((4, 5, 6)).astype(np.float32)
    x[0, 0, :3] = x[0, 0].max() + 1  # ties along the last axis
    got = check([O.make_node("ArgMax", ["x"], ["amax"], axis=axis,
                             keepdims=keepdims),
                 O.make_node("ArgMin", ["x"], ["amin"], axis=axis,
                             keepdims=keepdims)],
                {"x": x}, outs=["amax", "amin"])
    assert got["amax"].dtype == np.int32


def test_argmax_select_last_index():
    x = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 1.0, 2.0]], np.float32)
    got = check([O.make_node("ArgMax", ["x"], ["first"], axis=1, keepdims=0),
                 O.make_node("ArgMax", ["x"], ["last"], axis=1, keepdims=0,
                             select_last_index=1),
                 O.make_node("ArgMin", ["x"], ["lastmin"], axis=1,
                             keepdims=0, select_last_index=1)],
                {"x": x}, outs=["first", "last", "lastmin"])
    np.testing.assert_array_equal(got["last"], [2, 3])


@pytest.mark.parametrize("largest", [0, 1])
@pytest.mark.parametrize("axis", [-1, 0])
def test_topk_with_ties_and_signed_zeros(largest, axis):
    x = RNG.standard_normal((6, 8)).astype(np.float32)
    x[1, :4] = 0.5                       # ties
    x[2, :4] = (0.0, -0.0, 0.0, -0.0)    # +0.0 above -0.0
    x[:4, 5] = 1.25                      # ties along axis 0
    got = check([O.make_node("TopK", ["x", "k"], ["vals", "idx"],
                             axis=axis, largest=largest)],
                {"x": x}, [O.from_array(np.array([3], np.int64), "k")],
                ["vals", "idx"])
    np.testing.assert_array_equal(np.signbit(got["vals"]),
                                  np.signbit(got["vals"]))
    assert got["idx"].dtype == np.int32


def test_topk_then_gather_of_device_rows():
    x = RNG.standard_normal((6, 4)).astype(np.float32)
    table = RNG.standard_normal((6, 3)).astype(np.float32)
    got = check([O.make_node("TopK", ["x", "k"], ["vals", "idx"], axis=0),
                 O.make_node("Squeeze", ["idx", "zero"], ["rows"]),
                 O.make_node("Gather", ["x2", "rows"], ["picked"], axis=0),
                 O.make_node("Gather", ["hosttab", "rows"], ["hpick"]),
                 O.make_node("Reshape", ["rows", "shp"], ["r2"]),
                 O.make_node("Tile", ["r2", "reps"], ["tiled"]),
                 O.make_node("Transpose", ["tiled"], ["tt"])],
                {"x": x, "x2": table},
                [O.from_array(np.array([1], np.int64), "k"),
                 O.from_array(np.array([0], np.int64), "zero"),
                 O.from_array(np.arange(10, 16, dtype=np.int64), "hosttab"),
                 O.from_array(np.array([2, 2], np.int64), "shp"),
                 O.from_array(np.array([1, 2], np.int64), "reps")],
                ["vals", "idx", "picked", "hpick", "r2", "tiled", "tt"])
    np.testing.assert_array_equal(got["picked"], table[np.argmax(x, 0)])


def test_argmax_host_domain_stays_host():
    t = ITensor(np.array([[4, 1], [2, 9]]))
    out, = onnx_operator_implementation("ArgMax", [t],
                                        {"axis": 1, "keepdims": 0})
    assert isinstance(out, ITensor)
    np.testing.assert_array_equal(out.data, [0, 1])
    out, = onnx_operator_implementation(
        "ArgMin", [t], {"axis": 0, "keepdims": 1, "select_last_index": 1})
    np.testing.assert_array_equal(out.data, [[1, 0]])


def test_topk_device_k_rejected_and_ditensor_refuses_floats():
    with pytest.raises(ValueError, match="graph constant"):
        onnx_operator_implementation(
            "TopK", [FTensor(torch.zeros(2, 3)),
                     FTensor(torch.tensor([2.0]))], {})
    with pytest.raises(ValueError, match="integer"):
        DITensor(torch.zeros(2))


def test_reshape_to_device_target_raises_not_reads():
    """A Reshape whose target is a device integer would need a host read:
    it raises (the captured forward never syncs)."""
    x = RNG.standard_normal((2, 3)).astype(np.float32)
    nodes = [O.make_node("ArgMax", ["x"], ["i"], axis=1),
             O.make_node("Reshape", ["x", "i"], ["y"])]
    from .torch_parity import graph, port_model
    model = port_model(graph(nodes, {"x": x}))
    with pytest.raises((ValueError, TypeError)):
        model([x])


def test_classifier_with_argmax_head_float_and_int8():
    def with_head(m):
        m.graph.node.append(O.make_node("ArgMax", ["logits"], ["label"],
                                        axis=1, keepdims=0))
        m.graph.output.append(O.make_tensor_value_info(
            "label", O.TensorProto.INT64, None))
        return m

    kw = dict(batch=8, image_size=16, widths=(8,))
    proto = with_head(cnn.resnet_classifier(**kw))
    jproto = with_head(jcnn.resnet_classifier(**kw))
    x = RNG.standard_normal((8, 3, 16, 16)).astype(np.float32)
    port, ref = Model.from_onnx(proto, device="cpu"), nq.Model.from_onnx(jproto)
    logits, labels = port([x])
    np.testing.assert_array_equal(labels, run_jax(ref, [x])[1])
    np.testing.assert_array_equal(labels, logits.argmax(1))
    port.fold_batchnorm()
    ref.fold_batchnorm()
    stats = run_jax_stats(ref, x)
    q = port.quantize(bit_width=8, stats=stats)
    qlogits, qlabels = q([x])
    want = run_jax(ref.quantize(bit_width=8, stats=stats), [x])
    assert qlabels.dtype == want[1].dtype == np.int32
    np.testing.assert_array_equal(qlabels, want[1])
    np.testing.assert_array_equal(qlabels, qlogits.argmax(1))


def run_jax_stats(ref, x):
    import jax
    with jax.enable_x64(False):
        return ref.calibration_stats([x])
