"""The port's interop ops (``ops/interop.py``, ``ops/recurrent.py``) held
against the JAX package's on seeded inputs, in TPU-mode numerics (x64
off): hand-built QDQ and QOperator graphs (the counterparts of
``tests/test_qdq_conformance.py``'s pair and per-channel tests and
``tests/test_qoperator.py``'s spec tests), dynamic quantization,
ConstantOfShape, Cast, CastLike and LSTM/GRU with their optional inputs.

Integer outputs (quantized values, dequantized spec chains) are equal bit
for bit, to JAX and to the spec oracle; float recurrences are within 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu import tensor as JT
from numpy_quant_tpu.ops.registry import \
    onnx_operator_implementation as jax_op
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.ops.registry import onnx_operator_implementation
from numpy_quant_tpu_torch.tensor import FTensor, QTensor

FLOAT = O.TensorProto.FLOAT


def _graph(nodes, inputs, inits, outputs=("y",)):
    g = O.make_graph(nodes, "g",
                     [O.make_tensor_value_info(n, FLOAT, list(s))
                      for n, s in inputs],
                     [O.make_tensor_value_info(n, FLOAT, None)
                      for n in outputs], initializer=inits)
    return O.make_model(g)


def _run_both(proto, arrays, record=False):
    """(port model, port outputs, JAX model, JAX outputs)."""
    port = Model.from_onnx(proto, device="cpu")
    got = port(arrays, record=record)
    with jax.enable_x64(False):
        ref = nq.Model.from_onnx(
            nq.onnx.load_from_string(proto.SerializeToString()))
        want = ref(arrays, record=record)
    return port, got, ref, [np.asarray(w) for w in want]


def _integers_equal(port, ref, name):
    mine = _port_value(port, name)
    theirs = next(v for v in ref.values if v.name == name).data
    np.testing.assert_array_equal(mine.data.numpy(), np.asarray(theirs.data))
    return mine


def _port_value(model, name):
    return next(v for v in model.values if v.name == name).data


# -- QuantizeLinear / DequantizeLinear ----------------------------------------

@pytest.mark.parametrize("signed,zp", [(False, 128), (False, 0),
                                       (True, 0), (True, -10)])
def test_qdq_pair_matches_jax_and_fake_quantize(signed, zp):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(7, 33)) * 3).astype(np.float32)
    scale = np.float32(0.037)
    zdt = np.int8 if signed else np.uint8
    lo, hi = (-128, 127) if signed else (0, 255)
    proto = _graph(
        [O.make_node("QuantizeLinear", ["x", "s", "z"], ["q"], name="q"),
         O.make_node("DequantizeLinear", ["q", "s", "z"], ["y"], name="dq")],
        [("x", x.shape)], [O.from_array(scale, "s"),
                           O.from_array(zdt(zp), "z")])
    port, got, ref, want = _run_both(proto, [x], record=True)
    q = _integers_equal(port, ref, "q")
    # uint8 storage counts one more signed-range bit, as JAX's
    assert q.bit_width == (8 if signed else 9) and q.orig_dtype == zdt
    desired = torch.fake_quantize_per_tensor_affine(
        torch.from_numpy(x), float(scale), int(zp), lo, hi).numpy()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], desired)


def test_qdq_per_channel_matches_jax_and_fake_quantize():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(5, 12)) * 2).astype(np.float32)
    scales = (0.01 + rng.random(12) * 0.05).astype(np.float32)
    zps = rng.integers(-20, 20, size=12).astype(np.int8)
    proto = _graph(
        [O.make_node("QuantizeLinear", ["x", "s", "z"], ["q"], name="q",
                     axis=1),
         O.make_node("DequantizeLinear", ["q", "s", "z"], ["y"], name="dq",
                     axis=1)],
        [("x", x.shape)], [O.from_array(scales, "s"),
                           O.from_array(zps, "z")])
    port, got, ref, want = _run_both(proto, [x], record=True)
    _integers_equal(port, ref, "q")
    desired = torch.fake_quantize_per_channel_affine(
        torch.from_numpy(x), torch.from_numpy(scales),
        torch.from_numpy(zps.astype(np.int32)), 1, -128, 127).numpy()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], desired)


def test_dequantize_linear_of_narrow_initializers():
    """A weight stored int8 and a bias stored int32 dequantize with their
    node's (per-axis) scale, placed on the device once at import."""
    rng = np.random.default_rng(2)
    w = rng.integers(-128, 128, size=(6, 4)).astype(np.int8)
    ws = (0.01 + rng.random(4) * 0.02).astype(np.float32)
    b = rng.integers(-5000, 5000, size=(4,)).astype(np.int32)
    x = rng.normal(size=(3, 6)).astype(np.float32)
    proto = _graph(
        [O.make_node("DequantizeLinear", ["w", "ws"], ["wf"], name="dw",
                     axis=1),
         O.make_node("DequantizeLinear", ["b", "bs"], ["bf"], name="db"),
         O.make_node("MatMul", ["x", "wf"], ["xw"], name="mm"),
         O.make_node("Add", ["xw", "bf"], ["y"], name="add")],
        [("x", x.shape)], [O.from_array(w, "w"), O.from_array(ws, "ws"),
                           O.from_array(b, "b"),
                           O.from_array(np.float32(1e-4), "bs")])
    port, got, _, want = _run_both(proto, [x])
    wt = next(v for v in port.values if v.name == "w").data
    assert wt.orig_dtype == np.int8 and wt.placed.dtype == torch.int8
    assert next(v for v in port.values if v.name == "b").data.placed \
        is not None
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def test_wide_storage_is_refused_as_jax_refuses_it():
    x = np.ones((2, 3), np.float32)
    proto = _graph(
        [O.make_node("QuantizeLinear", ["x", "s", "z"], ["y"], name="q")],
        [("x", x.shape)], [O.from_array(np.float32(0.1), "s"),
                           O.from_array(np.int16(0), "z")])
    with pytest.raises(ValueError, match="int16"):
        Model.from_onnx(proto, device="cpu")([x])
    with jax.enable_x64(False), pytest.raises(ValueError, match="int16"):
        nq.Model.from_onnx(nq.onnx.load_from_string(
            proto.SerializeToString()))([x], record=True)


# -- QLinearMatMul / QLinearConv -----------------------------------------------

def _np_quantize(x, s, zp, info):
    return np.clip(np.rint(x / np.float32(s)) + zp, info.min, info.max)


@pytest.mark.parametrize("storage", ["int8", "uint8"])
def test_qlinearmatmul_matches_jax_and_spec(storage):
    rng = np.random.default_rng(42)
    m_, k, n = 6, 8, 5
    a_z, a_dt = (-3, np.int8) if storage == "int8" else (131, np.uint8)
    # power-of-two scales: the f32 executor and the f64 oracle round alike
    a_s, w_s, y_s, y_z = 0.0625, 0.03125, 0.25, 7
    wq = rng.integers(-100, 100, size=(k, n)).astype(np.int8)
    proto = _graph(
        [O.make_node("QuantizeLinear", ["x", "a_s", "a_z"], ["xq"],
                     name="qx"),
         O.make_node("QLinearMatMul", ["xq", "a_s", "a_z", "w", "w_s", "w_z",
                                       "y_s", "y_z"], ["yq"], name="qmm"),
         O.make_node("DequantizeLinear", ["yq", "y_s", "y_z"], ["y"],
                     name="dq")],
        [("x", (m_, k))],
        [O.from_array(np.float32(a_s), "a_s"), O.from_array(a_dt(a_z), "a_z"),
         O.from_array(wq, "w"), O.from_array(np.float32(w_s), "w_s"),
         O.from_array(np.int8(0), "w_z"), O.from_array(np.float32(y_s), "y_s"),
         O.from_array(np.int8(y_z), "y_z")])
    x = rng.normal(size=(m_, k)).astype(np.float32)
    port, got, ref, want = _run_both(proto, [x], record=True)
    _integers_equal(port, ref, "xq")
    _integers_equal(port, ref, "yq")
    aq = _np_quantize(x.astype(np.float64), a_s, a_z, np.iinfo(a_dt))
    acc = (aq - a_z) @ wq.astype(np.float64)
    info = np.iinfo(np.int8)
    yq = np.clip(np.rint(acc * a_s * w_s / np.float32(y_s)) + y_z,
                 info.min, info.max)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0],
                                  ((yq - y_z) * y_s).astype(np.float32))


def test_qlinearconv_matches_jax_and_spec():
    rng = np.random.default_rng(43)
    b, c, o, h, w_, kh, kw = 2, 3, 4, 5, 5, 2, 2
    a_s, a_z = 0.0625, 10
    w_s = np.asarray([0.03125, 0.0625, 0.015625, 0.125], np.float32)
    y_s, y_z = 0.5, -5
    wq = rng.integers(-100, 100, size=(o, c, kh, kw)).astype(np.int8)
    bias = rng.integers(-2000, 2000, size=(o,)).astype(np.int32)
    proto = _graph(
        [O.make_node("QuantizeLinear", ["x", "a_s", "a_z"], ["xq"],
                     name="qx"),
         O.make_node("QLinearConv", ["xq", "a_s", "a_z", "w", "w_s", "w_z",
                                     "y_s", "y_z", "bias"], ["yq"],
                     name="qlc", kernel_shape=[kh, kw], pads=[0, 0, 0, 0],
                     strides=[1, 1]),
         O.make_node("DequantizeLinear", ["yq", "y_s", "y_z"], ["y"],
                     name="dq")],
        [("x", (b, c, h, w_))],
        [O.from_array(np.float32(a_s), "a_s"), O.from_array(np.int8(a_z), "a_z"),
         O.from_array(wq, "w"), O.from_array(w_s, "w_s"),
         O.from_array(np.zeros(o, np.int8), "w_z"),
         O.from_array(np.float32(y_s), "y_s"), O.from_array(np.int8(y_z), "y_z"),
         O.from_array(bias, "bias")])
    x = rng.normal(size=(b, c, h, w_)).astype(np.float32)
    port, got, ref, want = _run_both(proto, [x], record=True)
    _integers_equal(port, ref, "yq")
    info = np.iinfo(np.int8)
    xq = _np_quantize(x.astype(np.float64), a_s, a_z, info) - a_z
    oh, ow = h - kh + 1, w_ - kw + 1
    acc = np.zeros((b, o, oh, ow))
    for i in range(oh):
        for j in range(ow):
            acc[:, :, i, j] = np.einsum("bckl,ockl->bo",
                                        xq[:, :, i:i + kh, j:j + kw],
                                        wq.astype(np.float64))
    acc += bias.astype(np.float64)[None, :, None, None]
    scale = (np.float32(a_s) * w_s).astype(np.float64)
    yq = np.clip(np.rint(acc * scale[None, :, None, None] / np.float32(y_s))
                 + y_z, info.min, info.max)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(
        got[0], ((yq - y_z) * np.float32(y_s)).astype(np.float32))


# -- dynamic quantization -------------------------------------------------------

def test_dynamic_quantize_matmul_integer_matches_jax():
    """onnxruntime's quantize_dynamic pattern: DynamicQuantizeLinear ->
    MatMulInteger (uint8 activation, int8 weight) -> Cast -> scale Mul."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    w = rng.integers(-127, 128, size=(16, 6)).astype(np.int8)
    proto = _graph(
        [O.make_node("DynamicQuantizeLinear", ["x"], ["xq", "xs", "xz"],
                     name="dql"),
         O.make_node("MatMulInteger", ["xq", "w", "xz", "wz"], ["acc"],
                     name="mmi"),
         O.make_node("Cast", ["acc"], ["accf"], name="cast", to=1),
         O.make_node("Mul", ["xs", "ws"], ["s"], name="s"),
         O.make_node("Mul", ["accf", "s"], ["y"], name="y")],
        [("x", x.shape)], [O.from_array(w, "w"),
                           O.from_array(np.int8(0), "wz"),
                           O.from_array(np.float32(0.02), "ws")])
    port, got, ref, want = _run_both(proto, [x], record=True)
    for name in ("xq", "xs", "xz", "acc"):
        _integers_equal(port, ref, name)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("granularity", ["row", "tensor"])
def test_dynamic_matmul_matches_jax(granularity):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 7, 24)) * 2).astype(np.float32)
    wq = rng.integers(-127, 128, size=(24, 10)).astype(np.int32)
    ws = (0.01 + rng.random((1, 10)) * 0.02).astype(np.float32)
    attrs = {"bit_width": 8, "granularity": granularity}
    got = onnx_operator_implementation(
        "DynamicMatMul",
        [FTensor(torch.from_numpy(x)), QTensor(torch.from_numpy(wq), 8, ws)],
        attrs)[0].data.numpy()
    with jax.enable_x64(False):
        want = np.asarray(jax_op(
            "DynamicMatMul", [JT.FTensor(x), JT.QTensor(wq, 8, ws)],
            attrs)[0].data)
    np.testing.assert_array_equal(got, want)


# -- ConstantOfShape, Cast, CastLike ------------------------------------------

@pytest.mark.parametrize("value", [None, np.array([2.5], np.float32),
                                   np.array([7], np.int64)],
                         ids=["default", "float", "int64"])
def test_constant_of_shape_matches_jax(value):
    x = np.ones((3, 4), np.float32)
    kw = {} if value is None else {"value": O.from_array(value, "v")}
    nodes = [O.make_node("Shape", ["x"], ["shp"], name="shape"),
             O.make_node("ConstantOfShape", ["shp"], ["c"], name="cos",
                         **kw),
             O.make_node("Cast", ["c"], ["cf"], name="cast", to=1),
             O.make_node("Add", ["x", "cf"], ["y"], name="add")]
    _, got, _, want = _run_both(_graph(nodes, [("x", x.shape)], []), [x])
    np.testing.assert_array_equal(got[0], want[0])


def test_cast_and_castlike_match_jax():
    """A shape tensor cast to float (Cast and CastLike), a float CastLike
    to float, and the int casts of the shape domain."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    nodes = [O.make_node("Shape", ["x"], ["shp"], name="shape"),
             O.make_node("Cast", ["shp"], ["shp64"], name="c64", to=7),
             O.make_node("CastLike", ["shp64", "shp"], ["shpi"], name="cli"),
             O.make_node("Cast", ["shpi"], ["sf"], name="cf", to=1),
             O.make_node("CastLike", ["shp", "x"], ["sl"], name="cl0"),
             O.make_node("ReduceMean", ["x"], ["m"], name="mean", axes=[0, 1],
                         keepdims=0),
             O.make_node("CastLike", ["m", "x"], ["ml"], name="clf"),
             O.make_node("Add", ["sf", "sl"], ["y0"], name="a0"),
             O.make_node("Add", ["y0", "ml"], ["y1"], name="a1"),
             O.make_node("Mul", ["y1", "y1"], ["y"], name="a2")]
    _, got, _, want = _run_both(_graph(nodes, [("x", x.shape)], []), [x])
    np.testing.assert_array_equal(got[0], want[0])


def test_cast_of_device_floats_to_int_is_refused():
    x = np.ones((2, 2), np.float32)
    proto = _graph([O.make_node("Cast", ["x"], ["y"], name="c", to=7)],
                   [("x", x.shape)], [])
    with pytest.raises(ValueError, match="shape domain"):
        Model.from_onnx(proto, device="cpu")([x])


# -- LSTM / GRU -----------------------------------------------------------------

def _recurrent_graph(op, direction, optionals, lbr, seed):
    rng = np.random.default_rng(seed)
    seq, batch, inp, hid = 5, 3, 4, 6
    nd = 2 if direction == "bidirectional" else 1
    g = 4 if op == "LSTM" else 3

    def arr(*shape):
        return (rng.normal(size=shape) * 0.5).astype(np.float32)

    inits = [O.from_array(arr(nd, g * hid, inp), "W"),
             O.from_array(arr(nd, g * hid, hid), "R")]
    ins = ["x", "W", "R"]
    if optionals:
        inits += [O.from_array(arr(nd, 2 * g * hid), "B"),
                  O.from_array(np.full(batch, seq, np.int32), "lens"),
                  O.from_array(arr(nd, batch, hid), "h0")]
        ins += ["B", "lens", "h0"]
        if op == "LSTM":
            inits.append(O.from_array(arr(nd, batch, hid), "c0"))
            ins.append("c0")
    outs = ["y_all", "y_h"] + (["y_c"] if op == "LSTM" else [])
    kw = {"linear_before_reset": lbr} if op == "GRU" else {}
    node = O.make_node(op, ins, outs, name="rnn", hidden_size=hid,
                       direction=direction, **kw)
    return _graph([node], [("x", (seq, batch, inp))], inits, outs), \
        arr(seq, batch, inp)


@pytest.mark.parametrize("op,lbr", [("LSTM", 0), ("GRU", 0), ("GRU", 1)])
@pytest.mark.parametrize("direction", ["forward", "reverse",
                                       "bidirectional"])
@pytest.mark.parametrize("optionals", [False, True],
                         ids=["plain", "bias-lens-initial"])
def test_recurrent_matches_jax(op, lbr, direction, optionals):
    proto, x = _recurrent_graph(op, direction, optionals, lbr, seed=7)
    _, got, _, want = _run_both(proto, [x])
    assert len(got) == (3 if op == "LSTM" else 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_recurrent_refusals_match_jax():
    """Ragged sequence_lens and peephole weights raise in both packages."""
    proto, x = _recurrent_graph("LSTM", "forward", True, 0, seed=8)
    ragged = O.load_from_string(proto.SerializeToString())
    for init in ragged.graph.initializer:
        if init.name == "lens":
            init.CopyFrom(O.from_array(np.array([5, 4, 5], np.int32),
                                       "lens"))
    with pytest.raises(ValueError, match="sequence_lens"):
        Model.from_onnx(ragged, device="cpu")([x])
    peep = O.load_from_string(proto.SerializeToString())
    peep.graph.initializer.append(O.from_array(
        np.zeros((1, 18), np.float32), "P"))
    peep.graph.node[0].input.append("P")
    with pytest.raises(ValueError, match="peephole"):
        Model.from_onnx(peep, device="cpu")([x])
