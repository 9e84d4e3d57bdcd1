"""Optional-input positions in the port (the counterpart of
``tests/test_optional_inputs.py``): absent optional inputs ("" names)
stay positional None slots, so Pad, Resize, Clip, LSTM and GRU read
each optional by position; every case's outputs equal the JAX
package's (LSTM/GRU within 1e-6), and a quantized graph with None slots
runs."""
import jax
import numpy as np
import pytest

from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.utils.summary import summarize

from .torch_parity import (FLOAT as F, INT64 as I64, graph, jax_model,
                           port_model, run_jax)

RNG = np.random.default_rng(7)


def _vi(name, dt, shape):
    return O.make_tensor_value_info(name, dt, shape)


def _both(nodes, in_infos, inits, inputs, rtol=0.0, atol=0.0):
    proto = graph(nodes, inits=inits, in_infos=in_infos)
    got = port_model(proto)(inputs)
    want = run_jax(jax_model(proto), inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return got


def test_pad_int_scalar_value_and_axes():
    x = np.arange(12, dtype=np.int64).reshape(3, 4)
    y, = _both([O.make_node("Pad", ["x", "p", "v", "ax"], ["y"])],
               [_vi("x", I64, [3, 4])],
               [O.from_array(np.array([1, 1], np.int64), "p"),
                O.from_array(np.int64(7), "v"),
                O.from_array(np.array([1], np.int64), "ax")], [x])
    np.testing.assert_array_equal(y, np.pad(x, ((0, 0), (1, 1)),
                                            constant_values=7))
    assert y.dtype == np.int64


def test_pad_empty_value_slot_with_axes_and_unknown_mode():
    x = RNG.normal(size=(2, 3, 4)).astype(np.float32)
    _both([O.make_node("Pad", ["x", "p", "", "ax"], ["y"])],
          [_vi("x", F, [2, 3, 4])],
          [O.from_array(np.array([1, 2], np.int64), "p"),
           O.from_array(np.array([2], np.int64), "ax")], [x])
    model = port_model(graph(
        [O.make_node("Pad", ["x", "p"], ["y"], mode="nonsense")], {"x": x},
        [O.from_array(np.zeros(6, np.int64), "p")]))
    with pytest.raises(ValueError, match="Pad mode"):
        model([x])


@pytest.mark.parametrize("ins,init", [
    (["x", "", "", "sz"], ("sz", np.array([1, 2, 8, 8], np.int64))),
    (["x", "", "s"], ("s", np.array([1, 1, 2, 2], np.float32)))])
def test_resize_optionals_by_position(ins, init):
    x = RNG.normal(size=(1, 2, 4, 4)).astype(np.float32)
    y, = _both([O.make_node("Resize", ins, ["y"], mode="nearest",
                            coordinate_transformation_mode="asymmetric",
                            nearest_mode="floor")],
               [_vi("x", F, list(x.shape))], [O.from_array(init[1], init[0])],
               [x])
    np.testing.assert_array_equal(y, np.repeat(np.repeat(x, 2, 2), 2, 3))


def test_clip_empty_min_slot():
    x = np.array([[-3.0, 0.5, 4.0]], np.float32)
    y, = _both([O.make_node("Clip", ["x", "", "mx"], ["y"])],
               [_vi("x", F, [1, 3])], [O.from_array(np.float32(1.0), "mx")],
               [x])
    np.testing.assert_array_equal(y, np.minimum(x, 1.0))


@pytest.mark.parametrize("op,names", [
    ("LSTM", ["x", "w", "r", "", "", "h0"]),
    ("LSTM", ["x", "w", "r", "", "", "", "c0"]),
    ("GRU", ["x", "w", "r", "", "", "h0"])])
def test_recurrent_lone_initial_states(op, names):
    seq, batch, isz, h = 3, 2, 4, 4
    g = 4 if op == "LSTM" else 3
    x = RNG.normal(size=(seq, batch, isz)).astype(np.float32)
    inits = [O.from_array(RNG.normal(size=(1, g * h, isz))
                          .astype(np.float32), "w"),
             O.from_array(RNG.normal(size=(1, g * h, h)).astype(np.float32),
                          "r")]
    for n in names[3:]:
        if n:
            inits.append(O.from_array(RNG.normal(size=(1, batch, h))
                                      .astype(np.float32), n))
    _both([O.make_node(op, names, ["y"], hidden_size=h)],
          [_vi("x", F, list(x.shape))], inits, [x], rtol=1e-6, atol=1e-6)


def test_lstm_peephole_rejected():
    x = RNG.normal(size=(2, 1, 3)).astype(np.float32)
    model = port_model(graph(
        [O.make_node("LSTM", ["x", "w", "r", "", "", "", "", "p"], ["y"],
                     hidden_size=3)], {"x": x},
        [O.from_array(RNG.normal(size=(1, 12, 3)).astype(np.float32), "w"),
         O.from_array(RNG.normal(size=(1, 12, 3)).astype(np.float32), "r"),
         O.from_array(RNG.normal(size=(1, 9)).astype(np.float32), "p")]))
    with pytest.raises(ValueError, match="peephole"):
        model([x])


def test_quantized_model_with_optional_slots():
    x = RNG.normal(size=(4, 6)).astype(np.float32)
    proto = graph([O.make_node("MatMul", ["x", "w"], ["mm"]),
                   O.make_node("Pad", ["mm", "p", "", ""], ["y"])],
                  {"x": x},
                  [O.from_array(RNG.normal(size=(6, 5)).astype(np.float32),
                                "w"),
                   O.from_array(np.array([0, 1, 0, 1], np.int64), "p")])
    port, ref = port_model(proto), jax_model(proto)
    with jax.enable_x64(False):
        stats = ref.calibration_stats([x])
    got = port.quantize(bit_width=8, stats=stats)([x])[0]
    np.testing.assert_array_equal(
        got, run_jax(ref.quantize(bit_width=8, stats=stats), [x])[0])
    assert len([n for n in port.nodes if n.op == "Pad"][0].inputs) == 2


def test_summary_skips_none_slots():
    x = RNG.normal(size=(2, 2)).astype(np.float32)
    model = port_model(graph(
        [O.make_node("Pad", ["x", "p", "", "ax"], ["y"], name="pd")],
        {"x": x}, [O.from_array(np.array([1, 1], np.int64), "p"),
                   O.from_array(np.array([0], np.int64), "ax")]))
    text = summarize(model)
    assert "pd" in text and "ax" in text


def test_int_data_through_clip_pow_reducesum_as_reshape_target():
    x = np.array([[1, 2, 3], [4, 5, 6]], np.int64)
    y, = _both([O.make_node("Clip", ["x", "lo", "hi"], ["c"]),
                O.make_node("Pow", ["c", "e"], ["pw"]),
                O.make_node("ReduceSum", ["pw"], ["rs"], keepdims=0,
                            axes=[0]),
                O.make_node("ReduceMax", ["rs"], ["y"], keepdims=1)],
               [_vi("x", I64, [2, 3])],
               [O.from_array(np.int64(2), "lo"),
                O.from_array(np.int64(5), "hi"),
                O.from_array(np.int64(2), "e")], [x])
    assert y.dtype == np.int64
    xf = RNG.normal(size=(2, 6)).astype(np.float32)
    y, = _both([O.make_node("ReduceSum", ["shp"], ["flat"], keepdims=0,
                            axes=[1]),
                O.make_node("Reshape", ["x", "flat"], ["y"])],
               [_vi("x", F, [2, 6])],
               [O.from_array(np.array([[3], [4]], np.int64), "shp")], [xf])
    np.testing.assert_array_equal(y, xf.reshape(3, 4))
