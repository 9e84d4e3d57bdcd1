"""BatchNormalization, ``fold_batchnorm`` and the ResNet generator in the
port, held against the JAX package (the counterpart of
``tests/test_batchnorm.py``): the op within rtol 2e-6 / atol 1e-6 of
JAX's, training mode refused, folded weights and biases equal to JAX's
bit for bit (the same numpy float32 fold), the folded ResNet within 1e-5
of the unfolded one, and the folded int8 ResNet's integers equal to
JAX's."""
import jax
import numpy as np
import pytest

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import cnn as jcnn
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.models import cnn
from numpy_quant_tpu_torch.tensor import FTensor

from .torch_parity import (assert_integers_equal, check, graph, jax_model,
                           jax_qvalues, port_model, run_jax)

RNG = np.random.default_rng(7)


def _bn_inits(c):
    return [O.from_array(RNG.uniform(0.5, 1.5, c).astype(np.float32), "gamma"),
            O.from_array(RNG.standard_normal(c).astype(np.float32), "beta"),
            O.from_array(RNG.standard_normal(c).astype(np.float32), "mean"),
            O.from_array(RNG.uniform(0.2, 2.0, c).astype(np.float32), "var")]


@pytest.mark.parametrize("shape", [(2, 5, 4, 3), (6, 5), (2, 5, 7)])
def test_batchnorm_op(shape):
    x = RNG.standard_normal(shape).astype(np.float32)
    check([O.make_node("BatchNormalization",
                       ["x", "gamma", "beta", "mean", "var"], ["y"],
                       epsilon=1e-3)], {"x": x}, _bn_inits(shape[1]),
          rtol=2e-6, atol=1e-6)


def test_batchnorm_training_mode_rejected():
    x = RNG.standard_normal((2, 3, 4, 4)).astype(np.float32)
    model = port_model(graph([O.make_node(
        "BatchNormalization", ["x", "gamma", "beta", "mean", "var"], ["y"],
        training_mode=1)], {"x": x}, _bn_inits(3)))
    with pytest.raises(ValueError, match="training_mode"):
        model([x])


def _folded_equal(port, ref):
    """Every float constant of the folded port model equals JAX's."""
    n = 0
    for v in port.values:
        if isinstance(v.data, FTensor):
            theirs = next(u for u in ref.values if u.name == v.name)
            np.testing.assert_array_equal(v.data.data.numpy(),
                                          np.asarray(theirs.data.data),
                                          err_msg=v.name)
            n += 1
    return n


@pytest.mark.parametrize("widths,n_bn", [((8, 16), 6), ((4,), 3)])
def test_fold_batchnorm_bit_equal_to_jax(widths, n_bn):
    kw = dict(batch=2, image_size=8, widths=widths)
    proto = cnn.resnet_classifier(**kw)
    assert proto.SerializeToString() == \
        jcnn.resnet_classifier(**kw).SerializeToString()
    x = RNG.standard_normal((2, 3, 8, 8)).astype(np.float32)
    port, ref = port_model(proto), jax_model(proto)
    before = port([x])[0]
    np.testing.assert_allclose(before, proto._torch_forward(x), atol=1e-4)
    assert port.fold_batchnorm() == ref.fold_batchnorm() == n_bn
    assert not any(n.op == "BatchNormalization" for n in port.nodes)
    assert [n.op for n in port.nodes] == [n.op for n in ref.nodes]
    assert all(len(n.inputs) == 3 for n in port.nodes if n.op == "Conv")
    assert _folded_equal(port, ref) >= 2 * n_bn
    after = port([x])[0]
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(after, run_jax(ref, [x])[0], atol=1e-5)


def test_fold_batchnorm_gemm_and_guards():
    k, n = 6, 5
    rnd = lambda *s: RNG.standard_normal(s).astype(np.float32)  # noqa: E731
    inits = [O.from_array(rnd(n, k), "w1"), O.from_array(rnd(n), "b1"),
             O.from_array(rnd(k, n), "w2"), O.from_array(rnd(n), "b2"),
             O.from_array(rnd(k, n), "w3")]
    for tag in ("p", "q", "r"):
        inits += [O.from_array(RNG.uniform(0.5, 1.5, n).astype(np.float32),
                               f"gamma_{tag}"),
                  O.from_array(rnd(n), f"beta_{tag}"),
                  O.from_array(rnd(n), f"mean_{tag}"),
                  O.from_array(RNG.uniform(0.2, 2.0, n).astype(np.float32),
                               f"var_{tag}")]

    def bn(tag, src, out):
        return O.make_node("BatchNormalization",
                           [src] + [f"{p}_{tag}" for p in
                                    ("gamma", "beta", "mean", "var")],
                           [out], epsilon=1e-4)

    nodes = [O.make_node("Gemm", ["x", "w1", "b1"], ["g1"], transB=1),
             bn("p", "g1", "y1"),
             O.make_node("Gemm", ["x", "w2", "b2"], ["g2"], beta=0.0),
             bn("q", "g2", "y2"),
             O.make_node("MatMul", ["x", "w3"], ["m3"]),
             bn("r", "m3", "y3"),
             O.make_node("Relu", ["g1"], ["relu_g1"])]
    x = RNG.standard_normal((3, k)).astype(np.float32)
    proto = graph(nodes, {"x": x}, inits, ["y1", "y2", "y3", "relu_g1"])
    port, ref = port_model(proto), jax_model(proto)
    before = port([x])
    assert port.fold_batchnorm() == ref.fold_batchnorm() == 1
    g2 = [nd for nd in port.nodes if nd.op == "Gemm"][1]
    assert float(g2.attrs["beta"]) == 1.0 and len(g2.inputs) == 3
    assert _folded_equal(port, ref) > 0
    for a, b in zip(port([x]), before):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_folded_resnet_int8_integers_equal_jax():
    kw = dict(batch=4, image_size=8, widths=(8, 16))
    x = RNG.standard_normal((4, 3, 8, 8)).astype(np.float32)
    port = Model.from_onnx(cnn.resnet_classifier(**kw), device="cpu")
    ref = nq.Model.from_onnx(jcnn.resnet_classifier(**kw))
    f = port([x])[0]
    port.fold_batchnorm()
    ref.fold_batchnorm()
    with jax.enable_x64(False):
        stats = ref.calibration_stats([x])
    qp = port.quantize(bit_width=8, stats=stats, quantize_conv=True)
    qj = ref.quantize(bit_width=8, stats=stats, quantize_conv=True)
    out = qp([x], record=True)[0]
    assert assert_integers_equal(qp, jax_qvalues(qj, [x])) >= 12
    want = run_jax(qj, [x])[0]
    np.testing.assert_allclose(out, want, atol=1e-5)
    np.testing.assert_array_equal(out.argmax(1), want.argmax(1))
    assert np.mean(np.abs(out - f)) / (f.max() - f.min()) < 0.08
