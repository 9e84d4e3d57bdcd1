"""The port's serialization and standard-format exports
(``utils/serialization.py``) held against the JAX package's, in TPU-mode
numerics (x64 off), on the reference's MLP (``mlp.onnx``: Gemm) and a
small ViT (1 layer, hidden 32, 2 heads, 16x16 images, 4x4 patches:
MatMul weights, the patch Conv).

* ``export_qdq`` / ``export_qoperator`` of the same QModel (JAX's payloads
  and params carried into the port with ``convert.load_jax_params``) give
  the same ONNX graph in both packages: node op types in order, names,
  inputs, outputs, attributes, and every initializer bit for bit.
* The exported files re-imported into the port meet the JAX package's
  round-trip rules (``tests/test_utils.py``, ``tests/test_qoperator.py``).
* ``save_qmodel`` / ``load_qmodel`` round-trip bit for bit, and a file
  saved by either package loads in the other and computes what the other
  package's loaded model computes: int8, sub-byte, per-channel, packed and
  ``quantize_conv`` models.
* Weight-only save/load, calibration stats, the external-data layout, and
  the stacked packed layout's refusal.
"""
import json

import jax
import numpy as np
import pytest
import torch
from transformers import ViTConfig
from transformers.models.vit.modeling_vit import ViTForImageClassification

import numpy_quant_tpu as nq
from numpy_quant_tpu import utils as JU
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.models import vit as JV
from numpy_quant_tpu.tensor import PackedQTensor as JPackedQTensor
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu_torch import Model, QModel
from numpy_quant_tpu_torch import config as TC
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch import utils as TU
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.graph import Constant
from numpy_quant_tpu_torch.models import vit as TV
from numpy_quant_tpu_torch.models.mlp import load_mlp
from numpy_quant_tpu_torch.tensor import PackedQTensor

CFG = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
           intermediate_size=64, image_size=16, patch_size=4, num_labels=4)
MODES = {
    "int8": dict(bit_width=8),
    "int4": dict(bit_width=4),
    "w4a8_per_channel": dict(bit_width=8, weight_bit_width=4,
                             per_channel_weights=True),
    "int8_conv": dict(bit_width=8, quantize_conv=True),
}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def vit():
    weights = TV.random_vit_weights(CFG, seed=0)
    hf = ViTForImageClassification(
        ViTConfig(**CFG, attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    x = np.random.default_rng(0).normal(size=(2, 3, 16, 16)) \
        .astype(np.float32)
    with jax.enable_x64(False):
        jproto = JV.vit_image_classifier(module=hf)
        stats = nq.Model.from_onnx(jproto).calibration_stats([x])
    return dict(jproto=jproto, tproto=TV.vit_image_classifier(weights, CFG),
                x=x, stats=stats)


@pytest.fixture(scope="module")
def mlp():
    x = np.random.default_rng(1).normal(size=(64, 2)).astype(np.float32)
    jproto = nq.onnx.load("numpy_quant_tpu/models/mlp.onnx")
    with jax.enable_x64(False):
        stats = nq.Model.from_onnx(jproto).calibration_stats([x])
    return dict(jproto=jproto, tproto=load_mlp(), x=x, stats=stats)


def _jax_state(jq) -> dict:
    """A JAX QModel's payloads and params as convert.load_jax_params
    takes them."""
    consts = {}
    for v in jq.values:
        if isinstance(v, JConstant) and isinstance(v.data, JPackedQTensor):
            p = v.data
            consts[v.name] = {"layout": p.layout, "k": p.k, "n": p.n,
                              "bit_width": p.bit_width,
                              "scale": np.asarray(p.scale, np.float32),
                              "payload": np.asarray(p.planes),
                              "colsum": np.asarray(p.colsum)}
        elif isinstance(v, JConstant) and isinstance(v.data, JQTensor):
            zp = v.data.zero_point
            consts[v.name] = {"payload": np.asarray(v.data.data),
                              "scale": np.asarray(v.data.scale, np.float32),
                              "zero_point": None if zp is None else int(zp),
                              "bit_width": v.data.bit_width}
    qps = {name: (np.asarray(qp.scale, np.float32),
                  None if qp.zero_point is None else int(qp.zero_point))
           for name, qp in jq.quant_params.items()}
    return {"constants": consts, "quant_params": qps}


def _pair(src, mode, optimize=False):
    """(JAX QModel, port QModel with JAX's payloads and params)."""
    kw = MODES[mode]
    jq = nq.Model.from_onnx(src["jproto"]).quantize(stats=src["stats"], **kw)
    tq = Model.from_onnx(src["tproto"], device="cpu").quantize(
        stats=src["stats"], **kw)
    load_jax_params(tq, _jax_state(jq))
    if optimize:
        jq.optimize()
        tq.optimize()
        assert jq.pack_weights() == tq.pack_weights() > 0
    return jq, tq


def _graph_of(proto, codec) -> tuple:
    def attr(a):
        val = codec.get_attribute_value(a)
        if isinstance(val, codec.TensorProto):
            arr = codec.to_array(val)
            return (arr.dtype.str, arr.shape, arr.tobytes())
        return val

    nodes = [(n.op_type, n.name, list(n.input), list(n.output),
              {a.name: attr(a) for a in n.attribute})
             for n in proto.graph.node]
    inits = [(t.name, codec.to_array(t).dtype.str, codec.to_array(t).shape,
              codec.to_array(t).tobytes()) for t in proto.graph.initializer]
    return nodes, inits


@pytest.mark.parametrize("export", ["export_qdq", "export_qoperator"])
@pytest.mark.parametrize("model,mode,optimize", [
    ("mlp", "int8", False), ("mlp", "w4a8_per_channel", False),
    ("vit", "int8", False), ("vit", "int8_conv", False),
    ("vit", "w4a8_per_channel", False), ("vit", "w4a8_per_channel", True)])
def test_exports_equal_jax(request, export, model, mode, optimize):
    src = request.getfixturevalue(model)
    jq, tq = _pair(src, mode, optimize)
    want = getattr(JU, export)(jq, src["jproto"])
    got = getattr(TU, export)(tq, src["tproto"])
    g_nodes, g_inits = _graph_of(got, O)
    w_nodes, w_inits = _graph_of(want, nq.onnx)
    assert [n[0] for n in g_nodes] == [n[0] for n in w_nodes]
    assert g_nodes == w_nodes
    assert g_inits == w_inits


@pytest.mark.parametrize("export", ["export_qdq", "export_qoperator"])
def test_exports_after_merge_equal_jax(vit, export):
    """After merge_parallel_matmuls (Q/K/V in one MatMulSplit) both
    packages re-slice the source weights out of the merged payload: the
    port's export equals JAX's, and its QDQ export equals the port's
    export of the same model optimized without the merge."""
    jq, tq = _pair(vit, "int8")
    _, plain = _pair(vit, "int8")
    jq._opt_merge_matmuls = tq._opt_merge_matmuls = True
    plain._opt_merge_matmuls = False
    assert jq.optimize()["merge_parallel_matmuls"] \
        == tq.optimize()["merge_parallel_matmuls"] == CFG["num_hidden_layers"]
    plain.optimize()
    want = getattr(JU, export)(jq, vit["jproto"])
    got = getattr(TU, export)(tq, vit["tproto"])
    assert _graph_of(got, O) == _graph_of(want, nq.onnx)
    if export == "export_qdq":
        assert got.SerializeToString() \
            == TU.export_qdq(plain, vit["tproto"]).SerializeToString()


def test_load_jax_params_installs_stacked_and_merged(vit):
    """convert.load_jax_params takes a tensor-parallel JAX QModel's stacked
    row groups byte for byte, and a merged model's '<node>/merged_w'
    payloads once the port's graph is merged the same way."""
    from numpy_quant_tpu import parallel as jpar
    from numpy_quant_tpu_torch import parallel as tpar
    from numpy_quant_tpu_torch.parallel.mesh import Mesh
    kw = MODES["w4a8_per_channel"]
    jq, plain = _pair(vit, "w4a8_per_channel")
    jpar.shard_model(jq, jpar.make_dp_tp_mesh(8, tp=2), rules=jpar.vit_tp_rules)
    assert jq.pack_weights() > 0
    tq = Model.from_onnx(vit["tproto"], device="cpu").quantize(
        stats=vit["stats"], **kw)
    tpar.shard_model(tq, Mesh(np.arange(8).reshape(4, 2), ("data", "model"),
                              "cpu"), rules=tpar.vit_tp_rules)
    tq.pack_weights()
    load_jax_params(tq, _jax_state(jq))
    jpayload = {v.name: v.data for v in jq.values
                if isinstance(getattr(v, "data", None), JPackedQTensor)}
    stacked = 0
    for v in tq.values:
        if getattr(v.data, "layout", None) == "splitk_stacked":
            assert v.data.planes.numpy().tobytes() \
                == np.asarray(jpayload[v.name].planes).tobytes()
            stacked += 1
    assert stacked == 2 * CFG["num_hidden_layers"]
    tq.mesh = None  # the stacked payloads, run whole
    np.testing.assert_array_equal(tq([vit["x"]])[0], plain([vit["x"]])[0])

    jm, tm = _pair(vit, "int8")
    jm._opt_merge_matmuls = tm._opt_merge_matmuls = True
    jm.optimize()
    tm.optimize()
    state = _jax_state(jm)
    merged = [n for n in state["constants"] if n.endswith("/merged_w")]
    assert len(merged) == CFG["num_hidden_layers"]
    assert load_jax_params(tm, state) == len(state["constants"])


def test_merged_forward_matches_jax(vit):
    """One merged forward (Q/K/V in a MatMulSplit) against JAX's merged
    single-device model on the same payloads, under the cross-package
    contract of the save/load test (labels equal, logits within 1e-2 of
    max|logit|), and equal to the port's unmerged forward bit for bit."""
    jq, tq = _pair(vit, "int8")
    _, plain = _pair(vit, "int8")
    jq._opt_merge_matmuls = tq._opt_merge_matmuls = True
    jq.optimize()
    tq.optimize()
    plain.optimize()
    assert [n.op for n in tq.nodes].count("MatMulSplit") \
        == CFG["num_hidden_layers"]
    x = vit["x"]
    got, want = tq([x])[0], np.asarray(jq([x])[0])
    np.testing.assert_array_equal(got, plain([x])[0])
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * float(np.abs(want).max()))


def _mean_abs(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).mean())


def test_export_qdq_roundtrip(mlp, vit, tmp_path):
    """JAX's rule (tests/test_utils.py::test_export_qdq_roundtrip): the
    MLP within 1e-4 of the integer QModel, the ViT's mean |dlogit| < 0.02
    with equal labels."""
    q = Model.from_onnx(mlp["tproto"], device="cpu").quantize(
        [mlp["x"]], bit_width=8)
    path = tmp_path / "mlp_qdq.onnx"
    TU.save_qmodel_qdq(q, path, mlp["tproto"])
    qdq = Model.from_onnx(O.load(path), device="cpu")
    assert {"QuantizeLinear", "DequantizeLinear"} <= {n.op for n in qdq.nodes}
    np.testing.assert_allclose(qdq([mlp["x"]])[0], q([mlp["x"]])[0],
                               atol=1e-4)
    qv = Model.from_onnx(vit["tproto"], device="cpu").quantize(
        [vit["x"]], bit_width=8)
    a = qv([vit["x"]])[0]
    b = Model.from_onnx(TU.export_qdq(qv, vit["tproto"]),
                        device="cpu")([vit["x"]])[0]
    assert _mean_abs(a, b) < 0.02
    np.testing.assert_array_equal(a.argmax(1), b.argmax(1))


def test_export_qoperator_vit_roundtrip(vit):
    """JAX's rule (tests/test_qoperator.py): every MatMul but each layer's
    probs @ v becomes a QLinearMatMul; mean |dlogit| < 0.05, equal
    labels."""
    qv = Model.from_onnx(vit["tproto"], device="cpu").quantize(
        [vit["x"]], bit_width=8)
    exported = TU.export_qoperator(qv, vit["tproto"])
    ops = [n.op_type for n in exported.graph.node]
    n_src = sum(n.op_type == "MatMul" for n in vit["tproto"].graph.node)
    assert ops.count("QLinearMatMul") == n_src - CFG["num_hidden_layers"]
    assert ops.count("MatMul") == CFG["num_hidden_layers"]
    a = qv([vit["x"]])[0]
    b = Model.from_onnx(exported, device="cpu")([vit["x"]])[0]
    assert _mean_abs(a, b) < 0.05
    np.testing.assert_array_equal(a.argmax(1), b.argmax(1))


@pytest.mark.parametrize("export", ["qdq", "qoperator"])
def test_export_after_optimize_and_pack(vit, tmp_path, export):
    """A W4A8 per-channel, optimize()d, pack_weights()ed QModel exports
    from the source graph and still matches the integer path (mean
    |dlogit| < 0.05, equal labels), under both packed executions."""
    q = Model.from_onnx(vit["tproto"], device="cpu").quantize(
        [vit["x"]], bit_width=8, weight_bit_width=4,
        per_channel_weights=True)
    q.optimize()
    assert q.pack_weights() > 0
    path = tmp_path / f"vit_w4a8_{export}.onnx"
    getattr(TU, f"save_qmodel_{export}")(q, path, vit["tproto"])
    proto = O.load(path)
    if export == "qoperator":
        assert "QLinearMatMul" in [n.op_type for n in proto.graph.node]
    b = Model.from_onnx(proto, device="cpu")([vit["x"]])[0]
    for execution in ("unpack", "kernel"):
        TC.packed_execution = execution
        try:
            a = q([vit["x"]])[0]
        finally:
            TC.packed_execution = "unpack"
        assert _mean_abs(a, b) < 0.05
        np.testing.assert_array_equal(a.argmax(1), b.argmax(1))


def test_export_qoperator_conv_and_gemm(vit, mlp):
    """quantize_conv exports the patch Conv as QLinearConv with its int32
    bias; the MLP's Gemms keep the QDQ form (no standard quantized Gemm)
    and round-trip within 1e-4."""
    qv = Model.from_onnx(vit["tproto"], device="cpu").quantize(
        [vit["x"]], bit_width=8, quantize_conv=True)
    exported = TU.export_qoperator(qv, vit["tproto"])
    qlc = [n for n in exported.graph.node if n.op_type == "QLinearConv"]
    assert len(qlc) == 1 and len(qlc[0].input) == 9
    assert "Conv" not in [n.op_type for n in exported.graph.node]
    a = qv([vit["x"]])[0]
    b = Model.from_onnx(exported, device="cpu")([vit["x"]])[0]
    assert _mean_abs(a, b) < 0.05
    q = Model.from_onnx(mlp["tproto"], device="cpu").quantize(
        [mlp["x"]], bit_width=8)
    ops = [n.op_type for n in TU.export_qoperator(q, mlp["tproto"])
           .graph.node]
    assert "Gemm" in ops and "QLinearMatMul" not in ops
    loaded = Model.from_onnx(TU.export_qoperator(q, mlp["tproto"]),
                             device="cpu")
    np.testing.assert_allclose(loaded([mlp["x"]])[0], q([mlp["x"]])[0],
                               atol=1e-4)


def _saved_pair(src, mode, pack):
    jq, tq = _pair(src, mode)
    if pack:
        assert jq.pack_weights() == tq.pack_weights() > 0
    return jq, tq


CROSS = [("mlp", "int8", False), ("mlp", "int4", False),
         ("mlp", "w4a8_per_channel", False), ("vit", "int8", True),
         ("vit", "w4a8_per_channel", True), ("vit", "int8_conv", False)]


@pytest.mark.parametrize("model,mode,pack", CROSS)
def test_save_load_roundtrip_and_cross_load(request, tmp_path, model, mode,
                                            pack):
    """The port's file loads back bit for bit in the port and loads in
    JAX; JAX's file loads in the port; each loaded model computes what the
    other package's loaded model computes on the same file."""
    src = request.getfixturevalue(model)
    jq, tq = _saved_pair(src, mode, pack)
    x = src["x"]
    t_path, j_path = tmp_path / "port.onnx", tmp_path / "jax.onnx"
    TU.save_qmodel(tq, t_path, src["tproto"])
    JU.save_qmodel(jq, j_path, src["jproto"])
    # the same file, byte for byte, from the same payloads and params
    assert t_path.read_bytes() == j_path.read_bytes()

    t_loaded = TU.load_qmodel(t_path, device="cpu")
    assert isinstance(t_loaded, QModel)
    assert t_loaded.bit_width == tq.bit_width
    assert set(t_loaded.quant_params) == set(tq.quant_params)
    assert t_loaded.quantized_ops == tq.quantized_ops
    if pack:
        assert sum(isinstance(v.data, PackedQTensor) for v in t_loaded.values
                   if isinstance(v, Constant)) \
            == sum(isinstance(v.data, PackedQTensor) for v in tq.values
                   if isinstance(v, Constant))
    want = tq([x])[0]
    np.testing.assert_array_equal(t_loaded([x])[0], want)

    from_jax = TU.load_qmodel(j_path, device="cpu")([x])[0]
    jax_loaded = JU.load_qmodel(t_path)([x])[0]
    np.testing.assert_array_equal(from_jax, want)
    np.testing.assert_array_equal(from_jax.argmax(1), jax_loaded.argmax(1))
    np.testing.assert_allclose(from_jax, jax_loaded, rtol=0,
                               atol=1e-2 * float(np.abs(jax_loaded).max()))


def test_save_qmodel_external_data(mlp, tmp_path):
    q = Model.from_onnx(mlp["tproto"], device="cpu").quantize(
        [mlp["x"]], bit_width=8)
    path = str(tmp_path / "q_ext.onnx")
    TU.save_qmodel(q, path, mlp["tproto"], external_data_threshold=16)
    assert (tmp_path / "q_ext.onnx.data").exists()
    np.testing.assert_array_equal(
        TU.load_qmodel(path, device="cpu")([mlp["x"]])[0], q([mlp["x"]])[0])


def test_stacked_layout_is_refused(vit, tmp_path):
    """The tensor-parallel stacked layout is no longer refused: packed under
    a tp = 2 layout, the port's file equals JAX's byte for byte, loads
    back stacked in the port and in JAX, and computes what the unsharded
    packed model computes."""
    from numpy_quant_tpu import parallel as jpar
    from numpy_quant_tpu_torch import parallel as tpar
    from numpy_quant_tpu_torch.parallel.mesh import Mesh
    jq, tq = _pair(vit, "w4a8_per_channel")
    _, plain = _saved_pair(vit, "w4a8_per_channel", True)
    jpar.shard_model(jq, jpar.make_dp_tp_mesh(8, tp=2), rules=jpar.vit_tp_rules)
    tpar.shard_model(tq, Mesh(np.arange(8).reshape(4, 2), ("data", "model"),
                              "cpu"), rules=tpar.vit_tp_rules)
    assert jq.pack_weights() == tq.pack_weights() > 0
    stacked = [v.name for v in tq.values
               if getattr(v.data, "layout", None) == "splitk_stacked"]
    assert len(stacked) == 2 * CFG["num_hidden_layers"]
    t_path, j_path = tmp_path / "port.onnx", tmp_path / "jax.onnx"
    TU.save_qmodel(tq, t_path, vit["tproto"])
    JU.save_qmodel(jq, j_path, vit["jproto"])
    assert t_path.read_bytes() == j_path.read_bytes()
    loaded = TU.load_qmodel(t_path, device="cpu")
    by_name = {v.name: v for v in loaded.values}
    for name in stacked:
        got, want = by_name[name].data, next(
            v.data for v in tq.values if v.name == name)
        assert got.layout == "splitk_stacked"
        assert got.planes.numpy().tobytes() == want.planes.numpy().tobytes()
        np.testing.assert_array_equal(got.colsum.numpy(), want.colsum.numpy())
    np.testing.assert_array_equal(loaded([vit["x"]])[0],
                                  plain([vit["x"]])[0])
    j_loaded = JU.load_qmodel(t_path)
    assert any(getattr(v.data, "layout", None) == "splitk_stacked"
               for v in j_loaded.values)


@pytest.mark.parametrize("bits,group", [(8, None), (4, 16), (3, None)])
def test_weight_only_save_load(vit, tmp_path, bits, group):
    """A weight-only model (quantize_weights: packed below 8 bits, grouped
    or per-channel scales) round-trips bit for bit; JAX's file of the same
    model carries the same payloads and loads to the same outputs."""
    tm = Model.from_onnx(vit["tproto"], device="cpu")
    jm = nq.Model.from_onnx(vit["jproto"])
    kw = dict(bit_width=bits, group_size=group)
    assert tm.quantize_weights(**kw) == jm.quantize_weights(**kw) > 0
    want = tm([vit["x"]])[0]
    t_path, j_path = tmp_path / "wo_port.onnx", tmp_path / "wo_jax.onnx"
    TU.save_weight_only(tm, t_path, vit["tproto"])
    JU.save_weight_only(jm, j_path, vit["jproto"])
    assert t_path.read_bytes() == j_path.read_bytes()
    loaded = TU.load_weight_only(t_path, device="cpu")
    assert type(loaded) is Model
    np.testing.assert_array_equal(loaded([vit["x"]])[0], want)
    np.testing.assert_array_equal(
        TU.load_weight_only(j_path, device="cpu")([vit["x"]])[0], want)


def test_calibration_stats_files_match_jax(mlp, tmp_path):
    t_path, j_path = tmp_path / "t.json", tmp_path / "j.json"
    TU.save_calibration_stats(mlp["stats"], t_path)
    JU.save_calibration_stats(mlp["stats"], j_path)
    assert t_path.read_text() == j_path.read_text()
    loaded = TU.load_calibration_stats(t_path)
    assert loaded.keys() == mlp["stats"].keys()
    for k, (mn, mx) in mlp["stats"].items():
        assert loaded[k] == (np.float32(mn), np.float32(mx))


def _gemm_source(shape_w, with_bias, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape_w) * 0.3).astype(np.float32)
    inits = [O.from_array(w, "w")]
    ins = ["x", "w"]
    if with_bias:
        inits.append(O.from_array(
            (rng.normal(size=shape_w[0]) * 0.1).astype(np.float32), "b"))
        ins.append("b")
    g = O.make_graph(
        [O.make_node("Gemm", ins, ["y"], name="g", transB=1)], "g",
        [O.make_tensor_value_info("x", O.TensorProto.FLOAT,
                                  [8, shape_w[1]])],
        [O.make_tensor_value_info("y", O.TensorProto.FLOAT, None)],
        initializer=inits)
    return O.make_model(g), rng.normal(size=(8, shape_w[1])).astype(
        np.float32)


@pytest.mark.parametrize("shape_w,with_bias,atol", [((6, 6), True, 1e-4),
                                                    ((5, 7), True, 1e-3)],
                         ids=["square", "bias"])
def test_export_qdq_per_channel_gemm(shape_w, with_bias, atol):
    """JAX's per-channel QDQ rules (tests/test_utils.py): a square Gemm
    weight takes its channel axis from the consumer (transB: axis 0), and
    the per-channel Gemm with its 1-D bias round-trips."""
    src, x = _gemm_source(shape_w, with_bias, seed=0)
    q = Model.from_onnx(src, device="cpu").quantize(
        [x], bit_width=8, per_channel_weights=True)
    exported = TU.export_qdq(q, src)
    dqw = next(n for n in exported.graph.node if n.name == "DQ_w")
    assert O.get_attribute_value(
        next(a for a in dqw.attribute if a.name == "axis")) == 0
    loaded = Model.from_onnx(exported, device="cpu")
    np.testing.assert_allclose(loaded([x])[0], q([x])[0], atol=atol)


def test_export_qoperator_square_per_channel_matmul_axis():
    """A square per-channel MatMul weight keeps the QDQ form (QLinearMatMul
    takes scalar scales); its DequantizeLinear's axis is the consumer's
    (MatMul rhs: axis 1)."""
    rng = np.random.default_rng(3)
    d = 6
    w = (rng.normal(size=(d, d)) * 0.3).astype(np.float32)
    src = O.make_model(O.make_graph(
        [O.make_node("MatMul", ["x", "w"], ["y"], name="mm")], "sq",
        [O.make_tensor_value_info("x", O.TensorProto.FLOAT, [8, d])],
        [O.make_tensor_value_info("y", O.TensorProto.FLOAT, None)],
        initializer=[O.from_array(w, "w")]))
    x = rng.normal(size=(8, d)).astype(np.float32)
    q = Model.from_onnx(src, device="cpu").quantize(
        [x], bit_width=8, per_channel_weights=True)
    exported = TU.export_qoperator(q, src)
    dqw = next(n for n in exported.graph.node if n.name == "DQ_w")
    assert O.get_attribute_value(
        next(a for a in dqw.attribute if a.name == "axis")) == 1
    np.testing.assert_allclose(
        Model.from_onnx(exported, device="cpu")([x])[0], q([x])[0],
        atol=1e-4)


def test_export_chained_gemm_no_duplicate_names():
    """Gemm -> Gemm: the first output is wrapped at its producer and read
    by a quantized op; both exports name each node and initializer once."""
    rng = np.random.default_rng(4)
    inits = [O.from_array(rng.normal(size=(5, 8)).astype(np.float32), "w1"),
             O.from_array(rng.normal(size=5).astype(np.float32), "b1"),
             O.from_array(rng.normal(size=(3, 5)).astype(np.float32), "w2")]
    src = O.make_model(O.make_graph(
        [O.make_node("Gemm", ["x", "w1", "b1"], ["h"], name="g1", transB=1),
         O.make_node("Gemm", ["h", "w2"], ["y"], name="g2", transB=1)], "gg",
        [O.make_tensor_value_info("x", O.TensorProto.FLOAT, [16, 8])],
        [O.make_tensor_value_info("y", O.TensorProto.FLOAT, None)],
        initializer=inits))
    x = rng.normal(size=(16, 8)).astype(np.float32)
    q = Model.from_onnx(src, device="cpu").quantize([x], bit_width=8)
    for export in (TU.export_qdq, TU.export_qoperator):
        exported = export(q, src)
        names = [i.name for i in exported.graph.initializer]
        assert len(names) == len(set(names)), export.__name__
        nodes = [n.name for n in exported.graph.node]
        assert len(nodes) == len(set(nodes)), export.__name__
        np.testing.assert_allclose(
            Model.from_onnx(exported, device="cpu")([x])[0], q([x])[0],
            atol=1e-3)
