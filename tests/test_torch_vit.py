"""The port's int8 ViT classifier held against the JAX package on a small
ViT (2 layers, hidden 64, 4 heads, intermediate 128, 32x32 images,
8x8 patches -> 17 tokens, 10 labels), in TPU-mode numerics (x64 off).

Tolerances: quantized intermediates may differ by 1 LSB on at most 0.1%
of entries (a float op -- exp, erf, a LayerNorm reduce -- may round a
value across a rint boundary in another order); the count is printed.
Labels are equal; logits agree within 1e-4 when no intermediate
differs, else within 1e-2 * max|logits|.

The packed paths (int8, W4A8 per-channel, W3A8 after optimize() and
pack_weights()) meet the same contract against JAX under
packed_execution="kernel", and the port's "kernel" forward equals its
"unpack" forward bit for bit."""
import jax
import numpy as np
import pytest
import torch
from transformers import ViTConfig
from transformers.models.vit.modeling_vit import ViTForImageClassification

import numpy_quant_tpu as nq
from numpy_quant_tpu import config as JC
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.models import vit as JV
from numpy_quant_tpu.tensor import PackedQTensor as JPackedQTensor
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch import onnx as T_ONNX
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.graph import Constant, Variable
from numpy_quant_tpu_torch.kernels import qmatmul as TQ
from numpy_quant_tpu_torch.kernels.attention import fused_attention_hs
from numpy_quant_tpu_torch.models import vit as TV
from numpy_quant_tpu_torch.tensor import PackedQTensor, QTensor

CFG = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, image_size=32, patch_size=8,
           num_labels=10)
PASSES = ("fuse_attention", "fuse_decode_attention",
          "merge_parallel_matmuls", "fuse_gelu", "narrow_gather",
          "int8_dataflow")
# the 8-bit-activation configurations: int8, W4A8 per-channel, W3A8
MODES = {k: c for k, c in TV.WEIGHT_CONFIGS.items() if c["bit_width"] <= 8}
# the dict form of weight_bit_width: per-weight widths, the rest at 8 bits
MIXED = {"bit_width": 8,
         "weight_bit_width": {"encoder.layer.0.intermediate.weight_t": 2,
                              "encoder.layer.1.attention.value.weight_t": 5,
                              "classifier.weight": 4},
         "per_channel_weights": True}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def setup():
    """Shared weights, both graphs, inputs and the JAX calibration."""
    weights = TV.random_vit_weights(CFG, seed=0)
    hf = ViTForImageClassification(
        ViTConfig(**CFG, attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 32, 32)).astype(np.float32)
    with jax.enable_x64(False):
        jproto = JV.vit_image_classifier(module=hf)
        stats = nq.Model.from_onnx(jproto).calibration_stats([x])
    return dict(weights=weights, hf=hf, jproto=jproto,
                tproto=TV.vit_image_classifier(weights, CFG), x=x,
                stats=stats)


def _jax_qmodel(s, mode="int8"):
    return nq.Model.from_onnx(s["jproto"]).quantize(
        stats=s["stats"], quantize_conv=True,
        **(MIXED if mode == "mixed" else MODES[mode]))


def _port_model(s):
    return Model.from_onnx(s["tproto"], device="cpu")


def _port_qmodel(s, stats=None, mode="int8"):
    return _port_model(s).quantize(stats=stats or s["stats"],
                                   quantize_conv=True,
                                   **(MIXED if mode == "mixed" else MODES[mode]))


def _jax_state(jq):
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


def _compare_end_to_end(jq, tq, x):
    """Run both with record=True; hold intermediates, labels, logits."""
    jy = jq([x], record=True)[0]
    ty = tq([x], record=True)[0]
    jdata = {v.name: v.data for v in jq.values}
    flips = total = 0
    for v in tq.values:
        if not isinstance(v, Variable) or not isinstance(v.data, QTensor) \
                or v.data.bit_width > 8:
            continue
        want = np.asarray(jdata[v.name].data).astype(np.int64)
        got = v.data.data.cpu().numpy().astype(np.int64)
        assert want.shape == got.shape, v.name
        diff = np.abs(want - got)
        assert diff.max(initial=0) <= 1, v.name
        flips += int((diff > 0).sum())
        total += want.size
    print(f"int8 intermediates differing by 1 LSB: {flips} of {total}")
    assert total > 0
    assert flips <= 0.001 * total
    np.testing.assert_array_equal(ty.argmax(axis=1), jy.argmax(axis=1))
    atol = 1e-4 if flips == 0 else 1e-2 * float(np.abs(jy).max())
    np.testing.assert_allclose(ty, jy, rtol=0, atol=atol)
    return ty, jy


def test_random_weights_follow_hf_layout(setup):
    hf_sd = setup["hf"].state_dict()
    w = setup["weights"]
    assert set(w) == set(hf_sd)
    for k, v in w.items():
        assert v.shape == tuple(hf_sd[k].shape) and v.dtype == np.float32, k
        if k.endswith(".bias"):
            assert not v.any(), k
        elif "layernorm" in k:
            assert (v == 1).all(), k
        else:
            assert np.abs(v).max() <= 0.04 and v.std() > 0.01, k


def test_builder_emits_the_jax_graph(setup):
    jg, tg = setup["jproto"].graph, setup["tproto"].graph

    def nodes(g, codec):
        out = []
        for n in g.node:
            attrs = {}
            for a in n.attribute:
                val = codec.get_attribute_value(a)
                if isinstance(val, codec.TensorProto):
                    arr = codec.to_array(val)
                    val = (arr.dtype.str, arr.shape, arr.tobytes())
                attrs[a.name] = val
            out.append((n.op_type, n.name, list(n.input), list(n.output),
                        attrs))
        return out

    def inits(g, codec):
        return [(t.name, codec.to_array(t).dtype.str,
                 codec.to_array(t).shape, codec.to_array(t).tobytes())
                for t in g.initializer]

    def vis(vs):
        return [(v.name, nq.onnx.value_info_shape(v)) for v in vs]

    assert nodes(tg, T_ONNX) == nodes(jg, nq.onnx)
    assert inits(tg, T_ONNX) == inits(jg, nq.onnx)
    assert vis(tg.input) == vis(jg.input)
    assert vis(tg.output) == vis(jg.output)


def test_quantize_constants_and_params_bit_equal(setup):
    _check_quantize_bit_equal(setup, "int8")


@pytest.mark.parametrize("mode", ["w4a8", "w3a8", "mixed"])
def test_quantize_weight_options_bit_equal(setup, mode):
    """per_channel_weights and weight_bit_width, as JAX quantizes them."""
    _check_quantize_bit_equal(setup, mode)


def _check_quantize_bit_equal(setup, mode):
    jq = _jax_qmodel(setup, mode)
    tq = _port_qmodel(setup, mode=mode)
    jconst = {v.name: v.data for v in jq.values
              if isinstance(v, JConstant) and isinstance(v.data, JQTensor)}
    tconst = {v.name: v.data for v in tq.values
              if isinstance(v, Constant) and isinstance(v.data, QTensor)}
    assert set(tconst) == set(jconst)
    for name, t in tconst.items():
        j = jconst[name]
        assert t.bit_width == j.bit_width, name
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(t.scale),
                                      np.asarray(j.scale), err_msg=name)
        assert t.zero_point == j.zero_point, name
    assert set(tq.quant_params) == set(jq.quant_params)
    for name, qp in tq.quant_params.items():
        np.testing.assert_array_equal(np.asarray(qp.scale),
                                      np.asarray(jq.quant_params[name].scale))
        assert qp.zero_point == jq.quant_params[name].zero_point, name
    assert tq.quantized_ops == jq.quantized_ops


def test_optimize_report_matches_jax(setup):
    jrep = _jax_qmodel(setup).optimize()
    trep = _port_qmodel(setup).optimize()
    print("optimize:", trep)
    assert set(trep) == set(PASSES) | {"fusion_failures"}
    for key in PASSES:
        assert trep[key] == jrep[key], key
    assert trep["fuse_attention"] == CFG["num_hidden_layers"]
    assert trep["fusion_failures"] == jrep["fusion_failures"] == []


def test_fused_graph_equals_unfused_executor(setup):
    """The fusion contract: in f32 mode the optimized QModel computes
    exactly what the port's own unfused executor computes."""
    tq = _port_qmodel(setup)
    x = setup["x"]
    unfused = tq([x])[0]
    tq.optimize()
    before = fused_attention_hs.launches
    fused = tq([x])[0]
    assert fused_attention_hs.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(fused, unfused)


@pytest.mark.parametrize("optimized", [False, True])
def test_end_to_end_matches_jax(setup, optimized):
    jq, tq = _jax_qmodel(setup), _port_qmodel(setup)
    if optimized:
        jq.optimize()
        tq.optimize()
    _compare_end_to_end(jq, tq, setup["x"])


def test_jax_params_carried_across(setup):
    """A port QModel calibrated on other images takes the JAX QModel's
    payloads and qparams and then computes what JAX computes."""
    jq = _jax_qmodel(setup)
    other = np.random.default_rng(1).normal(size=(2, 3, 32, 32)) \
        .astype(np.float32) * 2.0
    tm = _port_model(setup)
    tq = tm.quantize(bit_width=8, stats=tm.calibration_stats([other]),
                     quantize_conv=True)
    assert load_jax_params(tq, _jax_state(jq)) == sum(
        isinstance(v, Constant) and isinstance(v.data, QTensor)
        for v in tq.values)
    jq.optimize()
    tq.optimize()
    _compare_end_to_end(jq, tq, setup["x"])


def test_bf16_serving_mode_error_bound(setup):
    x = setup["x"]
    f = _port_model(setup)([x])[0]
    tq = _port_qmodel(setup)
    tq.optimize()
    q32 = tq([x])[0]
    with TC.low_precision_floats():
        qbf = tq([x])[0]
    assert TC.float_dtype == torch.float32
    assert qbf.dtype == np.float32 and np.isfinite(qbf).all()
    err32 = np.mean(np.abs(q32 - f))
    errbf = np.mean(np.abs(qbf - f))
    assert errbf <= max(2.5 * err32, 0.1), (errbf, err32)
    jq = _jax_qmodel(setup)
    jq.optimize()
    with JC.low_precision_floats():
        jq._jit_cache.clear()
        jbf = jq([x])[0]
    jq._jit_cache.clear()
    print(f"bf16 mode: mean|port-float| {errbf:.3g} (f32 mode {err32:.3g}), "
          f"max|port-jax| {np.abs(qbf - jbf).max():.3g}, labels equal "
          f"{(qbf.argmax(1) == jbf.argmax(1)).mean():.2f}")


def _packed_pair(s, mode):
    """JAX and port QModels after optimize() + pack_weights(); returns
    them with both packed-weight counts."""
    jq, tq = _jax_qmodel(s, mode), _port_qmodel(s, mode=mode)
    jq.optimize()
    tq.optimize()
    return jq, tq, jq.pack_weights(), tq.pack_weights()


@pytest.mark.parametrize("mode", list(MODES))
def test_pack_weights_matches_jax(setup, mode):
    jq, tq, jn, tn = _packed_pair(setup, mode)
    assert tn == jn == 6 * CFG["num_hidden_layers"]
    jpacked = {v.name: v.data for v in jq.values
               if isinstance(v, JConstant) and isinstance(v.data, JPackedQTensor)}
    tpacked = {v.name: v.data for v in tq.values
               if isinstance(v, Constant) and isinstance(v.data, PackedQTensor)}
    assert set(tpacked) == set(jpacked)
    for name, t in tpacked.items():
        j = jpacked[name]
        assert (t.layout, t.k, t.n, t.bit_width) == \
            (j.layout, j.k, j.n, j.bit_width), name
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes),
                                      err_msg=name)
        np.testing.assert_array_equal(t.colsum.numpy(), np.asarray(j.colsum),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(t.scale),
                                      np.asarray(j.scale), err_msg=name)


@pytest.mark.parametrize("mode", list(MODES))
def test_packed_kernel_path_matches_jax(setup, mode, monkeypatch):
    """JAX's packed state installed in the port (load_jax_params), both
    under packed_execution="kernel": the port meets the end-to-end
    contract against JAX and its kernel forward equals its unpack
    forward bit for bit."""
    jq, tq, _, _ = _packed_pair(setup, mode)
    assert load_jax_params(tq, _jax_state(jq)) == sum(
        isinstance(v, Constant) and isinstance(v.data, (QTensor, PackedQTensor))
        for v in tq.values)
    x = setup["x"]
    unpacked = tq([x])[0]
    monkeypatch.setattr(JC, "packed_execution", "kernel")
    monkeypatch.setattr(TC, "packed_execution", "kernel")
    jq._jit_cache.clear()
    launches = (TQ.splitk_qmatmul.launches, TQ.packed_qmatmul.launches)
    ty, _ = _compare_end_to_end(jq, tq, x)
    # CPU tensors take the kernels' plain versions
    assert (TQ.splitk_qmatmul.launches, TQ.packed_qmatmul.launches) == launches
    np.testing.assert_array_equal(ty, unpacked)
    jq._jit_cache.clear()
