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


# the host XLA's CPU float32 orders were mapped on (ops/registry.py::
# _ynn_lanes, intops.xla_cpu_row_sum and xla_cpu_exp): jaxlib 0.9 on an
# AVX-512 CPU
MAPPED_JAXLIB = "0.9."
MAPPED_CPU = "AVX512"


def assert_mapped_xla_cpu_host() -> None:
    """Fail, saying why, where this host is not the kind XLA's CPU orders
    were mapped on: another jaxlib or vector unit may hand a dot to
    another backend or tile it otherwise, and the CPU pins held to JAX bit
    for bit would part with no clear cause."""
    import jaxlib
    import torch
    assert jaxlib.__version__.startswith(MAPPED_JAXLIB), (
        f"jaxlib {jaxlib.__version__}: XLA's CPU orders were mapped on "
        f"jaxlib {MAPPED_JAXLIB}x; map them again "
        "(extras/xla_cpu_order_probe.py)")
    cap = torch.backends.cpu.get_cpu_capability()
    assert cap == MAPPED_CPU, (
        f"CPU capability {cap}: XLA's CPU orders were mapped on an "
        f"{MAPPED_CPU} host; map them again "
        "(extras/xla_cpu_order_probe.py)")


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


def graph_signature(proto):
    """(nodes as (op, inputs, outputs), input names, output names, sorted
    initializer names) of a ModelProto of either package."""
    g = proto.graph
    return ([(n.op_type, list(n.input), list(n.output)) for n in g.node],
            [i.name for i in g.input], [o.name for o in g.output],
            sorted(i.name for i in g.initializer))


def assert_same_graph(tproto, jproto):
    """The port's graph equals JAX's node for node, with equal
    initializers."""
    from numpy_quant_tpu import onnx as J_ONNX
    assert graph_signature(tproto) == graph_signature(jproto)
    jinit = {t.name: t for t in jproto.graph.initializer}
    for t in tproto.graph.initializer:
        np.testing.assert_array_equal(O.to_array(t),
                                      J_ONNX.to_array(jinit[t.name]),
                                      err_msg=t.name)


def jax_state(jq) -> dict:
    """A JAX QModel's quantized constants and quant params, in the layout
    ``numpy_quant_tpu_torch.convert.load_jax_params`` installs."""
    from numpy_quant_tpu.graph import Constant as JConstant
    from numpy_quant_tpu.tensor import QTensor as JQ
    consts = {}
    for v in jq.values:
        if isinstance(v, JConstant) and isinstance(v.data, JQ):
            zp = v.data.zero_point
            consts[v.name] = {"payload": np.asarray(v.data.data),
                              "scale": np.asarray(v.data.scale, np.float32),
                              "zero_point": None if zp is None else int(zp),
                              "bit_width": v.data.bit_width}
    qps = {name: (np.asarray(qp.scale, np.float32),
                  None if qp.zero_point is None else int(qp.zero_point))
           for name, qp in jq.quant_params.items()}
    return {"constants": consts, "quant_params": qps}


def greedy_hf(module, start_id: int, n_new: int, **enc_inputs) -> np.ndarray:
    """The token-by-token full re-forward greedy loop of a live
    encoder-decoder ``transformers`` module (JAX's tests' oracle):
    [B, 1 + n_new] int32 ids starting with ``start_id``."""
    import torch
    batch = next(iter(enc_inputs.values())).shape[0]
    ids = np.full((batch, 1), start_id, dtype=np.int64)
    feeds = {k: torch.from_numpy(v) for k, v in enc_inputs.items()}
    for _ in range(n_new):
        with torch.no_grad():
            logits = module(**feeds,
                            decoder_input_ids=torch.from_numpy(ids)).logits
        ids = np.concatenate([ids, logits[:, -1, :].argmax(-1).numpy()[:, None]],
                             axis=1)
    return ids.astype(np.int32)
