"""The GCN generators, GatherElements and ScatterElements in the port, held
against the JAX package (the counterpart of ``tests/test_gnn.py``):
graphs serialize as JAX's; float forwards within 1e-5 of JAX's and of a
numpy oracle; the int8 forwards (also packed, under both
``packed_execution`` settings) equal JAX's integers on shared stats; the
scatter applies duplicate updates in JAX's order (``set``: the last one
wins) and the round plan makes a scatter-add's sum order the update
order."""
import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
import numpy_quant_tpu.config as jconfig
from numpy_quant_tpu.models import gnn as jgnn
from numpy_quant_tpu.ops.registry import \
    onnx_operator_implementation as jax_op
from numpy_quant_tpu.tensor import FTensor as JF, ITensor as JI
from numpy_quant_tpu_torch import Model, config
from numpy_quant_tpu_torch.models import gnn
from numpy_quant_tpu_torch.ops.registry import onnx_operator_implementation
from numpy_quant_tpu_torch.tensor import FTensor, ITensor

from .torch_parity import assert_integers_equal, jax_qvalues, run_jax

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("mode", ["unpack", "kernel"])
def test_gcn_dense_float_int8_and_packed(mode):
    n, e, f, h, c = 40, 120, 16, 32, 4
    proto = gnn.gcn_dense(n, e, f, h, c, seed=0)
    assert proto.SerializeToString() == \
        jgnn.gcn_dense(n, e, f, h, c, seed=0).SerializeToString()
    w = proto._weights
    x = RNG.standard_normal((n, f)).astype(np.float32)
    port, ref = Model.from_onnx(proto, device="cpu"), nq.Model.from_onnx(
        jgnn.gcn_dense(n, e, f, h, c, seed=0))
    logits = port([x])[0]
    h1 = np.maximum((w["a_hat"] @ x) @ w["w1"] + w["b1"], 0.0)
    np.testing.assert_allclose(logits, (w["a_hat"] @ h1) @ w["w2"] + w["b2"],
                               atol=1e-5)
    np.testing.assert_allclose(logits, run_jax(ref, [x])[0], atol=1e-5)
    with jax.enable_x64(False):
        stats = ref.calibration_stats([x])
    qp, qj = (m.quantize(bit_width=8, stats=stats) for m in (port, ref))
    qp([x], record=True)
    assert assert_integers_equal(qp, jax_qvalues(qj, [x])) >= 4
    unpacked = qp([x])[0]
    for m in (qp, qj):
        m.optimize()
        assert m.pack_weights() == 2
    prev = config.packed_execution, jconfig.packed_execution
    config.packed_execution = jconfig.packed_execution = mode
    try:
        got = qp([x])[0]
        want = run_jax(qj, [x])[0]
    finally:
        config.packed_execution, jconfig.packed_execution = prev
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got, unpacked)
    assert (got.argmax(1) == logits.argmax(1)).mean() >= 0.9


def test_gcn_scatter_float_and_int8():
    n, e, f, c = 30, 90, 12, 5
    proto = gnn.gcn_scatter(n, e, f, c, seed=0)
    assert proto.SerializeToString() == \
        jgnn.gcn_scatter(n, e, f, c, seed=0).SerializeToString()
    w = proto._weights
    x = RNG.standard_normal((n, f)).astype(np.float32)
    port = Model.from_onnx(proto, device="cpu")
    ref = nq.Model.from_onnx(jgnn.gcn_scatter(n, e, f, c, seed=0))
    logits = port([x, w["src"]])[0]
    agg = np.zeros((n, f), np.float32)
    np.add.at(agg, w["dst"], x[w["src"]])
    np.testing.assert_allclose(logits, (agg + x) @ w["w"] + w["b"],
                               atol=1e-5)
    np.testing.assert_allclose(logits, run_jax(ref, [x, w["src"]])[0],
                               atol=1e-5)
    with jax.enable_x64(False):
        stats = ref.calibration_stats([x, w["src"]])
    qp, qj = (m.quantize(bit_width=8, stats=stats) for m in (port, ref))
    got = qp([x, w["src"]], record=True)[0]
    np.testing.assert_allclose(got, run_jax(qj, [x, w["src"]])[0], atol=1e-5)


@pytest.mark.parametrize("reduction", ["add", "none"])
@pytest.mark.parametrize("axis", [0, 1])
def test_scatter_and_gather_elements_match_jax(reduction, axis):
    data = RNG.standard_normal((4, 5)).astype(np.float32)
    # duplicates: updates to one destination apply in update order
    idx = np.array([[0, 1, 2, 0, 1], [1, 2, 3, 0, 1], [0, 1, 2, 0, 4]])
    idx = idx % 4 if axis == 0 else idx[:, :4]
    upd = RNG.standard_normal(idx.shape).astype(np.float32)
    attrs = {"axis": axis, "reduction": reduction}
    out, = onnx_operator_implementation(
        "ScatterElements", [FTensor(torch.tensor(data)), ITensor(idx),
                            FTensor(torch.tensor(upd))], attrs)
    with jax.enable_x64(False):
        want, = jax_op("ScatterElements", [JF(data), JI(idx), JF(upd)],
                       attrs)
        gwant, = jax_op("GatherElements", [want, JI(idx)], {"axis": axis})
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(want.data))
    g, = onnx_operator_implementation("GatherElements", [out, ITensor(idx)],
                                      {"axis": axis})
    np.testing.assert_array_equal(g.data.numpy(), np.asarray(gwant.data))


def test_scatter_add_sums_in_update_order():
    # 1e8 + 1 - 1e8 in float32: the order of the adds decides the result
    data = np.zeros((2, 1), np.float32)
    idx = ITensor(np.array([[0], [0], [0], [1]]))
    upd = np.array([[1e8], [1.0], [-1e8], [3.0]], np.float32)
    out, = onnx_operator_implementation(
        "ScatterElements", [FTensor(torch.tensor(data)), idx,
                            FTensor(torch.tensor(upd))], {"reduction": "add"})
    want = np.zeros((2, 1), np.float32)
    for i, u in zip(idx.data[:, 0], upd[:, 0]):
        want[i, 0] = np.float32(want[i, 0] + u)
    np.testing.assert_array_equal(out.data.numpy(), want)
    assert len(next(iter(idx.__dict__["_plans"].values()))) > 0


def test_host_scatter_and_gather_elements():
    data = ITensor(np.arange(12).reshape(3, 4))
    idx = ITensor(np.array([[2, 0, 1, 0]]))
    upd = ITensor(np.array([[5, 6, 7, 8]]))
    for red in ("none", "add"):
        out, = onnx_operator_implementation("ScatterElements",
                                            [data, idx, upd],
                                            {"reduction": red})
        want, = jax_op("ScatterElements", [JI(data.data), JI(idx.data),
                                           JI(upd.data)], {"reduction": red})
        assert isinstance(out, ITensor)
        np.testing.assert_array_equal(out.data, want.data)
    out, = onnx_operator_implementation("GatherElements", [data, idx], {})
    np.testing.assert_array_equal(out.data, [[8, 1, 6, 3]])
