"""ONNX If / Loop in the port, folded on the host as the JAX package folds
them at trace time (the counterpart of ``tests/test_control_flow.py``):
outputs equal JAX's, a device-resident condition or trip count raises the
same ValueError, too many iterations and a zero-iteration scan raise, a
Loop inside a quantized model dequantizes its captured QTensor at the
body boundary, nested bodies read the enclosing scopes, and a value read
only by a body stays alive until the If/Loop node runs."""
import numpy as np
import pytest

from numpy_quant_tpu_torch import onnx as O

from .torch_parity import (FLOAT as F, INT64 as I64, graph, jax_model,
                           port_model, run_jax)

RNG = np.random.default_rng(43)
BOOL = O.TensorProto.BOOL


def _vi(name, dt, shape):
    return O.make_tensor_value_info(name, dt, shape)


def _both(proto, arrays):
    got = port_model(proto)(list(arrays))
    want = run_jax(jax_model(proto), arrays)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    return got


def _if_model(batch):
    then_g = O.make_graph([O.make_node("Mul", ["x", "two"], ["then_y"])],
                          "then_g", [], [_vi("then_y", F, None)])
    else_g = O.make_graph([O.make_node("Add", ["x", "ten"], ["else_y"])],
                          "else_g", [], [_vi("else_y", F, None)])
    nodes = [O.make_node("Shape", ["x"], ["shape"]),
             O.make_node("Gather", ["shape", "zero"], ["b"], axis=0),
             O.make_node("Equal", ["b", "two_i"], ["cond"]),
             O.make_node("If", ["cond"], ["y"], then_branch=then_g,
                         else_branch=else_g)]
    inits = [O.from_array(np.array(0, np.int64), "zero"),
             O.from_array(np.array(2, np.int64), "two_i"),
             O.from_array(np.float32(2.0), "two"),
             O.from_array(np.float32(10.0), "ten")]
    return graph(nodes, inits=inits, in_infos=[_vi("x", F, [batch, 3])])


@pytest.mark.parametrize("batch", [2, 3])
def test_if_folds_on_host_shape_math(batch):
    x = RNG.normal(size=(batch, 3)).astype(np.float32)
    y, = _both(_if_model(batch), [x])
    np.testing.assert_array_equal(y, x * 2 if batch == 2 else x + 10)


def test_if_device_condition_raises_like_jax():
    then_g = O.make_graph([O.make_node("Identity", ["x"], ["ty"])], "t", [],
                          [_vi("ty", F, None)])
    else_g = O.make_graph([O.make_node("Neg", ["x"], ["ey"])], "e", [],
                          [_vi("ey", F, None)])
    proto = graph([O.make_node("Greater", ["s", "zero_f"], ["cond"]),
                   O.make_node("If", ["cond"], ["y"], then_branch=then_g,
                               else_branch=else_g)],
                  inits=[O.from_array(np.float32(0.0), "zero_f")],
                  in_infos=[_vi("x", F, [2, 2]), _vi("s", F, [])])
    args = [RNG.normal(size=(2, 2)).astype(np.float32), np.float32(1.5)]
    with pytest.raises(ValueError, match="host-resident"):
        port_model(proto)(args)
    with pytest.raises(ValueError, match="host-resident"):
        run_jax(jax_model(proto), args)


def _loop_model(trip, shape=(2, 2)):
    body = O.make_graph(
        [O.make_node("Identity", ["cond_in"], ["cond_out"]),
         O.make_node("Add", ["v_in", "x"], ["v_out"]),
         O.make_node("Identity", ["v_out"], ["scan"])],
        "body", [_vi("it", I64, []), _vi("cond_in", BOOL, []),
                 _vi("v_in", F, list(shape))],
        [_vi("cond_out", BOOL, []), _vi("v_out", F, list(shape)),
         _vi("scan", F, list(shape))])
    nodes = [O.make_node("Loop", ["m", "", "v0"], ["v_final", "v_all"],
                         body=body)]
    inits = [O.from_array(np.array(trip, np.int64), "m"),
             O.from_array(np.zeros(shape, np.float32), "v0")]
    return graph(nodes, inits=inits, outs=["v_final", "v_all"],
                 in_infos=[_vi("x", F, list(shape))])


def test_loop_static_trip_count_unrolls():
    x = RNG.normal(size=(2, 2)).astype(np.float32)
    v_final, v_all = _both(_loop_model(4), [x])
    np.testing.assert_allclose(v_all, np.stack([x, 2 * x, 3 * x, 4 * x]),
                               rtol=1e-6)


def test_loop_zero_iteration_scan_raises_like_jax():
    x = RNG.normal(size=(2, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="zero iterations"):
        port_model(_loop_model(0))([x])
    with pytest.raises(ValueError, match="zero iterations"):
        run_jax(jax_model(_loop_model(0)), [x])


def _cond_loop(limit_name, cond_node):
    body = O.make_graph(
        [cond_node, O.make_node("Add", ["v_in", "x"], ["v_out"])],
        "body", [_vi("it", I64, []), _vi("cond_in", BOOL, []),
                 _vi("v_in", F, [2])],
        [_vi("cond_out", BOOL, []), _vi("v_out", F, [2])])
    return graph([O.make_node("Loop", ["", "cond0", "v0"], ["v_final"],
                              body=body)],
                 inits=[O.from_array(np.array(True), "cond0"),
                        O.from_array(np.zeros(2, np.float32), "v0"),
                        O.from_array(np.array(3, np.int64), "limit")],
                 outs=["v_final"], in_infos=[_vi("x", F, [2])])


def test_loop_host_condition_terminates():
    x = RNG.normal(size=(2,)).astype(np.float32)
    y, = _both(_cond_loop("limit", O.make_node("Less", ["it", "limit"],
                                               ["cond_out"])), [x])
    np.testing.assert_allclose(y, 4 * x, rtol=1e-6)


def test_loop_errors_match_jax():
    x = RNG.normal(size=(2,)).astype(np.float32)
    # a device termination condition (the body compares floats)
    dev = _cond_loop("limit", O.make_node("Greater", ["v_in", "v_in"],
                                          ["cond_out"]))
    # a condition that never turns false
    forever = _cond_loop("limit", O.make_node("Identity", ["cond_in"],
                                              ["cond_out"]))
    for proto, match in ((dev, "data-dependent Loop termination"),
                         (forever, "exceeded 10000")):
        with pytest.raises(ValueError, match=match):
            port_model(proto)([x])
        with pytest.raises(ValueError, match=match):
            run_jax(jax_model(proto), [x])


def test_loop_in_quantized_model_dequantizes_captures():
    import jax
    w = RNG.normal(size=(3, 3)).astype(np.float32)
    body = O.make_graph(
        [O.make_node("Identity", ["cond_in"], ["cond_out"]),
         O.make_node("Add", ["v_in", "h"], ["v_out"])],
        "body", [_vi("it", I64, []), _vi("cond_in", BOOL, []),
                 _vi("v_in", F, [2, 3])],
        [_vi("cond_out", BOOL, []), _vi("v_out", F, [2, 3])])
    proto = graph([O.make_node("MatMul", ["x", "w"], ["h"]),
                   O.make_node("Loop", ["m", "", "v0"], ["y"], body=body)],
                  inits=[O.from_array(w, "w"),
                         O.from_array(np.array(3, np.int64), "m"),
                         O.from_array(np.zeros((2, 3), np.float32), "v0")],
                  in_infos=[_vi("x", F, [2, 3])])
    x = RNG.normal(size=(2, 3)).astype(np.float32)
    y, = _both(proto, [x])
    np.testing.assert_allclose(y, 3 * (x @ w), rtol=1e-5, atol=1e-6)
    ref = jax_model(proto)
    with jax.enable_x64(False):
        stats = ref.calibration_stats([x])
    got = port_model(proto).quantize(bit_width=8, stats=stats)([x])[0]
    want = run_jax(ref.quantize(bit_width=8, stats=stats), [x])[0]
    np.testing.assert_array_equal(got, want)


def test_nested_if_in_loop_reads_both_scopes():
    # the If inside the body reads the body's v_in and the graph's x
    inner_then = O.make_graph([O.make_node("Add", ["v_in", "x"], ["a"])],
                              "it", [], [_vi("a", F, None)])
    inner_else = O.make_graph([O.make_node("Sub", ["v_in", "x"], ["b"])],
                              "ie", [], [_vi("b", F, None)])
    body = O.make_graph(
        [O.make_node("Less", ["it", "one"], ["first"]),
         O.make_node("If", ["first"], ["v_out"], then_branch=inner_then,
                     else_branch=inner_else),
         O.make_node("Identity", ["cond_in"], ["cond_out"])],
        "body", [_vi("it", I64, []), _vi("cond_in", BOOL, []),
                 _vi("v_in", F, [2])],
        [_vi("cond_out", BOOL, []), _vi("v_out", F, [2])])
    proto = graph([O.make_node("Loop", ["m", "", "v0"], ["y"], body=body)],
                  inits=[O.from_array(np.array(3, np.int64), "m"),
                         O.from_array(np.ones(2, np.float32), "v0"),
                         O.from_array(np.array(1, np.int64), "one")],
                  in_infos=[_vi("x", F, [2])])
    x = RNG.normal(size=(2,)).astype(np.float32)
    y, = _both(proto, [x])
    np.testing.assert_allclose(y, 1 + x - x - x, rtol=1e-6)
