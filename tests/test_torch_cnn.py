"""The CNN generator, the shape ops Flatten/Squeeze/Pow/Clip/ReduceSum/
Split and the pools in the port, held against the JAX package (the
counterpart of ``tests/test_cnn.py``): generators serialize to JAX's
graphs byte for byte; the float forward is within 1e-5 of JAX's and of
the model's torch oracle; the int8 forwards (float Conv and integer
Conv) equal JAX's integers and labels on shared calibration stats;
MaxPool with asymmetric padding is equal, AveragePool within 1e-6."""
import jax
import numpy as np
import pytest

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import cnn as jcnn
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.models import cnn

from .torch_parity import (assert_integers_equal, check, jax_qvalues,
                           run_jax)

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("make,kw", [
    ("cnn_classifier", dict(batch=4, image_size=32)),
    ("cnn_classifier", dict(batch=2, image_size=8, widths=(4,), seed=3)),
    ("mobilenet_classifier", dict(batch=2, image_size=16, widths=(8, 16))),
    ("resnet_classifier", dict(batch=2, image_size=16, widths=(8, 16, 32))),
    ("unet_segmenter", dict(batch=1, image_size=16, width=6)),
    ("lstm_classifier", dict(seq=9, batch=5, input_size=6, hidden=8)),
])
def test_generators_serialize_as_jax(make, kw):
    assert getattr(cnn, make)(**kw).SerializeToString() == \
        getattr(jcnn, make)(**kw).SerializeToString()


@pytest.mark.parametrize("quantize_conv", [False, True])
def test_cnn_float_and_int8(quantize_conv):
    kw = dict(batch=4, image_size=16)
    x = RNG.standard_normal((4, 3, 16, 16)).astype(np.float32)
    proto = cnn.cnn_classifier(**kw)
    port = Model.from_onnx(proto, device="cpu")
    ref = nq.Model.from_onnx(jcnn.cnn_classifier(**kw))
    f = port([x])[0]
    np.testing.assert_allclose(f, run_jax(ref, [x])[0], atol=1e-5)
    np.testing.assert_allclose(f, proto._torch_forward(x), atol=1e-5)
    with jax.enable_x64(False):
        stats = ref.calibration_stats([x])
    qp = port.quantize(bit_width=8, stats=stats, quantize_conv=quantize_conv)
    qj = ref.quantize(bit_width=8, stats=stats, quantize_conv=quantize_conv)
    out = qp([x], record=True)[0]
    assert assert_integers_equal(qp, jax_qvalues(qj, [x])) >= 1
    want = run_jax(qj, [x])[0]
    np.testing.assert_allclose(out, want, atol=1e-5)
    np.testing.assert_array_equal(out.argmax(1), want.argmax(1))
    denom = f.max() - f.min()
    assert np.mean(np.abs(out - f)) / denom < 0.08


def test_shape_ops():
    x = RNG.standard_normal((2, 3, 4)).astype(np.float32)
    nodes = [O.make_node("Flatten", ["x"], ["flat"], axis=1),
             O.make_node("Pow", ["x", "two"], ["pow"]),
             O.make_node("Clip", ["x", "lo", "hi"], ["clip"]),
             O.make_node("ReduceSum", ["x", "rax"], ["rsum"], keepdims=1),
             O.make_node("Abs", ["x"], ["abs"]),
             O.make_node("Split", ["x"], ["s0", "s1"], axis=2, split=[1, 3]),
             O.make_node("Unsqueeze", ["x", "uax"], ["unsq"]),
             O.make_node("Squeeze", ["unsq", "uax"], ["sq"]),
             O.make_node("Squeeze", ["unsq"], ["sqall"])]
    inits = [O.from_array(np.array(2.0, np.float32), "two"),
             O.from_array(np.array(-0.5, np.float32), "lo"),
             O.from_array(np.array(0.5, np.float32), "hi"),
             O.from_array(np.array([1], np.int64), "rax"),
             O.from_array(np.array([0], np.int64), "uax")]
    got = check(nodes, {"x": x}, inits,
                ["flat", "pow", "clip", "rsum", "abs", "s0", "s1", "sq",
                 "sqall"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got["sq"], x)


@pytest.mark.parametrize("pads,strides,kernel,cip", [
    ((1, 1, 1, 1), (2, 2), (3, 3), 0), ((0, 0, 0, 0), (2, 2), (2, 2), 0),
    ((0, 1, 2, 0), (1, 2), (3, 2), 0), ((1, 0, 1, 2), (2, 1), (2, 3), 1)])
def test_pools(pads, strides, kernel, cip):
    x = RNG.standard_normal((2, 3, 9, 9)).astype(np.float32)
    attrs = dict(kernel_shape=list(kernel), strides=list(strides),
                 pads=list(pads))
    check([O.make_node("MaxPool", ["x"], ["mp"], **attrs),
           O.make_node("AveragePool", ["x"], ["ap"], count_include_pad=cip,
                       **attrs),
           O.make_node("GlobalAveragePool", ["x"], ["gap"])],
          {"x": x}, outs=["mp", "ap", "gap"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("make,kw", [
    ("resnet_classifier", dict(batch=2, image_size=8, widths=(8, 16))),
    ("mobilenet_classifier", dict(batch=2, image_size=8, widths=(8, 16))),
])
def test_optimized_int8_cnn_equals_jax(make, kw):
    """fold_batchnorm (ResNet) -> quantize(8, quantize_conv) -> optimize(),
    the chain the card runs: int8_dataflow plans the same values, and the
    outputs equal JAX's."""
    x = RNG.standard_normal((2, 3, 8, 8)).astype(np.float32)
    port = Model.from_onnx(getattr(cnn, make)(**kw), device="cpu")
    ref = nq.Model.from_onnx(getattr(jcnn, make)(**kw))
    if make == "resnet_classifier":
        port.fold_batchnorm()
        ref.fold_batchnorm()
    with jax.enable_x64(False):
        stats = ref.calibration_stats([x])
    qp = port.quantize(bit_width=8, stats=stats, quantize_conv=True)
    qj = ref.quantize(bit_width=8, stats=stats, quantize_conv=True)
    rp = qp.optimize()
    with jax.enable_x64(False):
        rj = qj.optimize()
    assert rp["int8_dataflow"] == rj["int8_dataflow"] > 0
    assert qp._int8_values == qj._int8_values
    np.testing.assert_allclose(qp([x])[0], run_jax(qj, [x])[0], atol=1e-5)
