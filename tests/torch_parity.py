"""Shared helpers of the port's parity tests: one ONNX graph, built with
the port's own ``onnx`` module, run through the JAX package (TPU-mode
numerics: x64 off) and through the port on the CPU."""
import jax
import numpy as np

import numpy_quant_tpu as nq
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import onnx as O

FLOAT = O.TensorProto.FLOAT
INT64 = O.TensorProto.INT64


def graph(nodes, feeds=None, inits=(), outs=("y",), in_infos=None):
    """A ModelProto: ``feeds`` ({name: array}) give the inputs' infos
    (float32 -> FLOAT, else INT64) unless ``in_infos`` are given."""
    if in_infos is None:
        in_infos = [O.make_tensor_value_info(
            n, FLOAT if np.asarray(a).dtype == np.float32 else INT64,
            list(np.shape(a))) for n, a in (feeds or {}).items()]
    out_infos = [O.make_tensor_value_info(n, FLOAT, None) for n in outs]
    return O.make_model(O.make_graph(list(nodes), "g", in_infos, out_infos,
                                     initializer=list(inits)))


def jax_model(proto):
    return nq.Model.from_onnx(
        nq.onnx.load_from_string(proto.SerializeToString()))


def port_model(proto):
    return Model.from_onnx(proto, device="cpu")


def run_jax(model, arrays, **kw):
    with jax.enable_x64(False):
        return [np.asarray(o) for o in model(list(arrays), **kw)]


def run_both(proto, arrays):
    """(port outputs, JAX outputs) of one forward over ``arrays``."""
    return port_model(proto)(list(arrays)), run_jax(jax_model(proto), arrays)


def assert_matches(got, want, rtol=0.0, atol=0.0, err_msg=""):
    """Same shape and dtype; values equal, or within rtol/atol. A host
    (ITensor) output is int64 in the port, as in JAX's x64 mode and its
    eager walks; JAX's jitted TPU-mode forward hands it out as int32."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    if not (got.dtype == np.int64 and want.dtype == np.int32):
        assert got.dtype == want.dtype, (err_msg, got.dtype, want.dtype)
    if rtol == 0.0 and atol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=err_msg)


def check(nodes, feeds, inits=(), outs=("y",), rtol=0.0, atol=0.0):
    """Run one graph through both packages and hold every output of the
    port to JAX's; returns the port's outputs by name."""
    got, want = run_both(graph(nodes, feeds, inits, outs),
                         list(feeds.values()))
    for name, g, w in zip(outs, got, want):
        assert_matches(g, w, rtol, atol, err_msg=name)
    return dict(zip(outs, got))


def value(model, name):
    """The recorded tensor of a value (after ``model(..., record=True)``)."""
    return next(v for v in model.values if v.name == name).data


def jax_qvalues(qmodel, arrays) -> dict:
    """{value name: integer data} of every QTensor one forward of a JAX
    QModel makes, from one jitted walk (its record mode runs op by op,
    seconds per graph on the CPU)."""
    from numpy_quant_tpu.tensor import QTensor as JQ

    def fn(floats, params):
        it = iter(floats)
        ins = {v.name: qmodel._wrap_input(next(it), v) for v in qmodel.inputs}
        data = qmodel._forward(ins, params)
        return {k: t.data for k, t in data.items() if isinstance(t, JQ)}

    with jax.enable_x64(False):
        out = jax.jit(fn)(list(arrays), qmodel._placed_params())
        return {k: np.asarray(v) for k, v in out.items()}


def assert_integers_equal(port_qmodel, want: dict) -> int:
    """Every QTensor the port recorded (``record=True``) equals JAX's
    (``jax_qvalues``) bit for bit; returns how many were compared."""
    from numpy_quant_tpu_torch.tensor import QTensor
    n = 0
    for v in port_qmodel.values:
        if isinstance(v.data, QTensor) and v.name in want:
            np.testing.assert_array_equal(
                v.data.data.numpy().astype(np.int64),
                want[v.name].astype(np.int64), err_msg=v.name)
            n += 1
    return n
