"""The port's extended ops held against the JAX package's (the
counterpart of ``tests/test_extra_ops.py``): grouped, dilated and 1-D
float Conv, grouped and dilated integer Conv (accumulators equal to
JAX's and to an exact int64 oracle), Pad (every mode, negative pads,
axes, device pad values), Resize (JAX's ``_resize`` grid), Gelu in both
forms, InstanceNormalization, Min/Max/ReduceMin/ReduceMax, and the
MobileNet and U-Net generators through quantize.

Float Conv outputs are within atol 2e-5 of JAX's (XLA's and torch's
convolutions sum in other orders); Gelu and normalization within rtol
2e-6 / atol 1e-6 (TOL); data movement (Pad, nearest Resize, Min/Max)
is equal, linear Resize within 1e-6. Quantized models share JAX's
calibration stats, so every integer intermediate is equal."""
import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import cnn as jcnn
from numpy_quant_tpu.tensor import QTensor as JQ, qconv2d as jax_qconv2d
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.models import cnn
from numpy_quant_tpu_torch.tensor import QTensor, qconv2d

from .torch_parity import (assert_integers_equal, check, graph,
                           jax_qvalues, port_model, run_jax)

TOL = dict(rtol=2e-6, atol=1e-6)
RNG = np.random.default_rng(0)


@pytest.mark.parametrize("group,dils", [(2, (1, 1)), (1, (2, 3)),
                                        (4, (2, 1)), (8, (1, 1))])
def test_conv_grouped_dilated_float(group, dils):
    x = RNG.normal(size=(2, 8, 11, 9)).astype(np.float32)
    w = RNG.normal(size=(8, 8 // group, 3, 2)).astype(np.float32)
    b = RNG.normal(size=8).astype(np.float32)
    node = O.make_node("Conv", ["x", "w", "b"], ["y"], pads=[1, 0, 2, 1],
                       strides=[2, 1], dilations=list(dils), group=group,
                       kernel_shape=[3, 2])
    check([node], {"x": x}, [O.from_array(w, "w"), O.from_array(b, "b")],
          atol=2e-5)


@pytest.mark.parametrize("group,pads,stride", [(1, (1, 2), 1), (3, (0, 0), 2)])
def test_conv_1d_float_and_dequantized(group, pads, stride):
    x = RNG.normal(size=(2, 6, 13)).astype(np.float32)
    w = RNG.normal(size=(9, 6 // group, 3)).astype(np.float32)
    b = RNG.normal(size=9).astype(np.float32)
    proto = graph([O.make_node("Conv", ["x", "w", "b"], ["y"],
                               pads=list(pads), strides=[stride],
                               group=group, kernel_shape=[3])],
                  {"x": x}, [O.from_array(w, "w"), O.from_array(b, "b")])
    got = check(proto.graph.node, {"x": x},
                [O.from_array(w, "w"), O.from_array(b, "b")], atol=2e-5)
    tx = torch.nn.functional.pad(torch.tensor(x), pads)
    np.testing.assert_allclose(got["y"], torch.nn.functional.conv1d(
        tx, torch.tensor(w), torch.tensor(b), stride=stride,
        groups=group).numpy(), atol=2e-5)
    # quantized operands dequantize and the 1-D Conv runs float
    from numpy_quant_tpu.ops.registry import \
        onnx_operator_implementation as jax_op
    from numpy_quant_tpu_torch.ops.registry import \
        onnx_operator_implementation
    xq = RNG.integers(-128, 128, size=x.shape).astype(np.int32)
    wq = RNG.integers(-127, 128, size=w.shape).astype(np.int32)
    attrs = dict(pads=list(pads), strides=[stride], group=group)
    out, = onnx_operator_implementation(
        "Conv", [QTensor(torch.tensor(xq), 8, np.float32(0.05), np.int64(3)),
                 QTensor(torch.tensor(wq), 8, np.float32(0.01))], attrs)
    with jax.enable_x64(False):
        want, = jax_op("Conv", [JQ(xq, 8, np.float32(0.05), np.int64(3)),
                                JQ(wq, 8, np.float32(0.01))], attrs)
    np.testing.assert_allclose(out.data.numpy(), np.asarray(want.data),
                               atol=2e-5)


@pytest.mark.parametrize("group,dils,zp_x,per_channel", [
    (2, (1, 1), 7, False), (1, (2, 2), 7, True), (4, (2, 1), None, True),
    (8, (1, 1), -3, True)])
def test_qconv2d_grouped_integer_exact(group, dils, zp_x, per_channel):
    b, c, o = 2, 8, 8
    pads, strides = (1, 1, 1, 1), (2, 2)
    xq = RNG.integers(-128, 128, size=(b, c, 9, 9)).astype(np.int32)
    wq = RNG.integers(-64, 64, size=(o, c // group, 3, 3)).astype(np.int32)
    sx = np.float32(0.02)
    sw = (RNG.uniform(0.001, 0.01, o).astype(np.float32) if per_channel
          else np.float32(0.005))
    zp = None if zp_x is None else np.int64(zp_x)
    out = qconv2d(QTensor(torch.tensor(xq), 8, sx, zp),
                  QTensor(torch.tensor(wq), 8, sw, None), None, pads,
                  strides, dils, group)
    with jax.enable_x64(False):
        want = jax_qconv2d(JQ(xq, 8, sx, zp), JQ(wq, 8, sw, None), None,
                           pads, strides, dils, group)
        want_zp = None if want.zero_point is None \
            else np.asarray(want.zero_point)
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(np.asarray(out.scale),
                                  np.asarray(want.scale))
    if want_zp is None:
        assert out.zero_point is None
    else:
        np.testing.assert_array_equal(
            np.broadcast_to(out.zero_point.numpy(), out.data.shape),
            np.broadcast_to(want_zp, out.data.shape))
    # exact oracle: conv of (xq - zp_x) and wq in float64
    tx = torch.tensor((xq - (zp_x or 0)).astype(np.float64))
    tx = torch.nn.functional.pad(tx, (pads[1], pads[3], pads[0], pads[2]))
    oracle = torch.nn.functional.conv2d(
        tx, torch.tensor(wq.astype(np.float64)), None, stride=strides,
        dilation=dils, groups=group).numpy().astype(np.int64)
    acc = out.data.numpy().astype(np.int64)
    if out.zero_point is not None:
        acc = acc - out.zero_point.numpy().astype(np.int64)
    np.testing.assert_array_equal(acc, oracle)
    assert out.bit_width == 32


@pytest.mark.parametrize("mode,pads,shape", [
    ("constant", [1, 0, 0, 2], (2, 3)),
    ("reflect", [1, 2, 1, 1], (3, 4)),
    ("edge", [1, 2, 1, 1], (3, 4)),
    ("wrap", [1, 2, 1, 1], (3, 4)),
    ("constant", [-1, 1, 0, -2], (4, 5)),
    ("edge", [-1, 1, 2, -2], (4, 5)),
])
def test_pad_modes_and_crops(mode, pads, shape):
    x = RNG.normal(size=shape).astype(np.float32)
    check([O.make_node("Pad", ["x", "p", "v"], ["y"], mode=mode)], {"x": x},
          [O.from_array(np.array(pads, np.int64), "p"),
           O.from_array(np.float32(2.5), "v")])
    xi = np.arange(np.prod(shape), dtype=np.int64).reshape(shape)
    check([O.make_node("Pad", ["x", "p"], ["y"], mode=mode)], {"x": xi},
          [O.from_array(np.array(pads, np.int64), "p")])


def test_pad_axes_and_device_value():
    x = RNG.normal(size=(2, 3, 4)).astype(np.float32)
    got = check([O.make_node("Pad", ["x", "p", "", "ax"], ["y"]),
                 O.make_node("ReduceMax", ["x"], ["m"], keepdims=0),
                 O.make_node("Pad", ["x", "p", "m", "ax"], ["ym"])],
                {"x": x}, [O.from_array(np.array([1, 2], np.int64), "p"),
                           O.from_array(np.array([2], np.int64), "ax")],
                ["y", "ym"])
    np.testing.assert_array_equal(got["y"],
                                  np.pad(x, ((0, 0), (0, 0), (1, 2))))
    assert got["ym"][0, 0, 0] == x.max()


@pytest.mark.parametrize("mode,ctm,nearest,scales,sizes", [
    ("nearest", "asymmetric", "floor", [1, 1, 2.0, 3.0], None),
    ("nearest", "half_pixel", "round_prefer_floor", [1, 1, 1.5, 0.5], None),
    ("nearest", "align_corners", "ceil", None, [1, 3, 7, 4]),
    ("nearest", "pytorch_half_pixel", "round_prefer_ceil", [1, 1, 2, 2], None),
    ("linear", "pytorch_half_pixel", None, [1, 1, 2.0, 1.6], None),
    ("linear", "align_corners", None, None, [1, 3, 7, 9]),
    ("linear", "half_pixel", None, [1, 1, 0.5, 1.5], None),
    ("linear", "asymmetric", None, [1, 1, 3, 2], None),
])
def test_resize_grid(mode, ctm, nearest, scales, sizes):
    x = RNG.normal(size=(1, 3, 5, 6)).astype(np.float32)
    attrs = dict(mode=mode, coordinate_transformation_mode=ctm)
    if nearest:
        attrs["nearest_mode"] = nearest
    inits, ins = [], ["x", ""]
    if scales is not None:
        inits.append(O.from_array(np.array(scales, np.float32), "s"))
        ins.append("s")
    else:
        inits.append(O.from_array(np.array(sizes, np.int64), "sz"))
        ins += ["", "sz"]
    check([O.make_node("Resize", ins, ["y"], **attrs)], {"x": x}, inits,
          atol=0.0 if mode == "nearest" else 1e-6,
          rtol=0.0 if mode == "nearest" else 1e-6)
    # host integers resize on the host (JAX's op outside a jitted walk)
    from numpy_quant_tpu.ops.registry import \
        onnx_operator_implementation as jax_op
    from numpy_quant_tpu.tensor import FTensor as JF, ITensor as JI
    from numpy_quant_tpu_torch.ops.registry import \
        onnx_operator_implementation
    from numpy_quant_tpu_torch.tensor import FTensor, ITensor
    xi = np.arange(30, dtype=np.int64).reshape(1, 1, 5, 6)
    pi, ji = [ITensor(xi), None], [JI(xi), None]
    if scales is not None:
        sc = np.array(scales, np.float32)
        f = FTensor(torch.tensor(sc))
        f.host = sc
        g = JF(sc)
        g.host = sc
        pi.append(f)
        ji.append(g)
    else:
        pi += [None, ITensor(np.array(sizes))]
        ji += [None, JI(np.array(sizes))]
    out, = onnx_operator_implementation("Resize", pi, attrs)
    want, = jax_op("Resize", ji, attrs)
    assert isinstance(out, ITensor)
    np.testing.assert_array_equal(out.data, want.data)


def test_resize_antialias_rejected():
    x = RNG.normal(size=(1, 1, 4, 4)).astype(np.float32)
    model = port_model(graph(
        [O.make_node("Resize", ["x", "", "s"], ["y"], mode="linear",
                     antialias=1)], {"x": x},
        [O.from_array(np.array([1, 1, 0.5, 0.5], np.float32), "s")]))
    with pytest.raises(ValueError, match="antialias"):
        model([x])


@pytest.mark.parametrize("approximate", ["none", "tanh"])
def test_gelu(approximate):
    x = (RNG.normal(size=(3, 17)) * 3).astype(np.float32)
    got = check([O.make_node("Gelu", ["x"], ["y"], approximate=approximate)],
                {"x": x}, **TOL)
    np.testing.assert_allclose(got["y"], torch.nn.functional.gelu(
        torch.tensor(x), approximate=approximate).numpy(), atol=2e-5)


def test_instance_norm_min_max_reduce_min():
    x = RNG.normal(size=(2, 4, 5, 6)).astype(np.float32)
    s = RNG.normal(size=4).astype(np.float32)
    b = RNG.normal(size=4).astype(np.float32)
    c = RNG.normal(size=(1, 6)).astype(np.float32)
    check([O.make_node("InstanceNormalization", ["x", "s", "b"], ["y"],
                       epsilon=1e-5)], {"x": x},
          [O.from_array(s, "s"), O.from_array(b, "b")], rtol=1e-5, atol=2e-6)
    check([O.make_node("Min", ["x", "c"], ["lo"]),
           O.make_node("Max", ["x", "c", "x"], ["hi"]),
           O.make_node("ReduceMin", ["x"], ["rmn"], axes=[1], keepdims=0),
           O.make_node("ReduceMax", ["x", "ax"], ["rmx"], keepdims=0)],
          {"x": x, "c": c}, [O.from_array(np.array([2], np.int64), "ax")],
          ["lo", "hi", "rmn", "rmx"])


def _both_quantized(make, kw, x, quantize_conv):
    """(port float, JAX float, port int8, JAX int8) outputs of one generator,
    the quantized models sharing JAX's calibration stats."""
    port = Model.from_onnx(getattr(cnn, make)(**kw), device="cpu")
    ref = nq.Model.from_onnx(getattr(jcnn, make)(**kw))
    with jax.enable_x64(False):
        stats = ref.calibration_stats([x])
    qp = port.quantize(bit_width=8, stats=stats, quantize_conv=quantize_conv)
    qj = ref.quantize(bit_width=8, stats=stats, quantize_conv=quantize_conv)
    return (port([x])[0], run_jax(ref, [x])[0], qp, jax_qvalues(qj, [x]),
            qp([x], record=True)[0], run_jax(qj, [x])[0])


@pytest.mark.parametrize("quantize_conv", [False, True])
def test_mobilenet_float_and_quantized(quantize_conv):
    kw = dict(batch=2, image_size=8, widths=(8, 16), n_classes=5, seed=0)
    x = RNG.normal(size=(2, 3, 8, 8)).astype(np.float32)
    yf, jf, qp, qj, yq, jq = _both_quantized("mobilenet_classifier", kw, x,
                                             quantize_conv)
    np.testing.assert_allclose(yf, jf, atol=1e-5)
    np.testing.assert_allclose(
        yf, cnn.mobilenet_classifier(**kw)._torch_forward(x), atol=1e-4)
    assert assert_integers_equal(qp, qj) >= (10 if quantize_conv else 2)
    np.testing.assert_allclose(yq, jq, atol=1e-5)
    np.testing.assert_array_equal(yq.argmax(1), jq.argmax(1))


def test_unet_float_and_quantized_keeps_resize_scales_float():
    kw = dict(batch=2, image_size=8, width=4, n_classes=3, seed=0)
    x = RNG.normal(size=(2, 3, 8, 8)).astype(np.float32)
    yf, jf, qp, qj, yq, jq = _both_quantized("unet_segmenter", kw, x, True)
    np.testing.assert_allclose(yf, jf, atol=1e-5)
    from numpy_quant_tpu_torch.tensor import FTensor
    scales = next(v for v in qp.values if v.name == "up.scales")
    assert isinstance(scales.data, FTensor)
    assert assert_integers_equal(qp, qj) >= 5
    np.testing.assert_allclose(yq, jq, atol=1e-5)
