"""The port's LLaMA causal LM (RMSNorm + RoPE + SwiGLU + grouped-query
attention) held against the JAX package on a tiny config (2 layers,
hidden 64, 4 heads, 2 KV heads, head_dim 16, vocab 128), in TPU-mode
numerics (x64 off). JAX builds its graph from a ``transformers``
``LlamaForCausalLM`` loaded with the port's ``random_llama_weights``; the
port builds its own from the same numpy weights.

Tolerances: the graphs, RoPE tables, quantized constants, qparams, the
``optimize()`` report and the FusedAttention attributes are equal. Float
logits agree within 1e-5 * max|logit| (f32 sums in another order). The
port's calibration stats lie within 1e-5 relative of JAX's. With JAX's
stats (or its whole quantized state, ``load_jax_params``) installed, the
port's fused f32 forward equals its unfused one bit for bit and goes
through ``fused_attention`` once per layer; against JAX, int8
intermediates differ by at most 1 LSB on at most 0.1% of entries, where a
float op (exp, the sigmoid, an RMSNorm mean) rounds across a rint boundary
in another order (the count is printed), and logits agree within 1e-4
when none differs, else within 1e-2 * max|logit| (the bounds of
tests/test_torch_vit.py). The bf16 serving mode is finite and within 5% of
max|logit| of f32. One case runs the full-context blockwise tiling at seq
1024 (B=1).
"""
import jax
import numpy as np
import pytest
import torch
from transformers import LlamaConfig, MistralConfig
from transformers.models.llama.modeling_llama import LlamaForCausalLM
from transformers.models.mistral.modeling_mistral import MistralForCausalLM

import numpy_quant_tpu as nq
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.graph import Variable as JVariable
from numpy_quant_tpu.models import llama as JL
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.graph import Constant, Variable
from numpy_quant_tpu_torch.kernels import attention as TA
from numpy_quant_tpu_torch.models import llama as TL
from numpy_quant_tpu_torch.tensor import QTensor

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=1024, rms_norm_eps=1e-5, rope_theta=10000.0,
           initializer_range=0.02, tie_word_embeddings=False)
LAYERS = CFG["num_hidden_layers"]
WINDOW = 6
# (batch, seq) per case: the monolithic-size context and the full context
CASES = {16: 2, 1024: 1}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _hf(cls, config_cls, weights, **extra):
    hf = cls(config_cls(**CFG, attn_implementation="eager", **extra)).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return hf


@pytest.fixture(scope="module")
def lm():
    weights = TL.random_llama_weights(CFG, seed=0)
    return dict(weights=weights,
                hf=_hf(LlamaForCausalLM, LlamaConfig, weights), cache={})


def _jax_state(jq):
    consts = {}
    for v in jq.values:
        if isinstance(v, JConstant) and isinstance(v.data, JQTensor):
            zp = v.data.zero_point
            consts[v.name] = {"payload": np.asarray(v.data.data),
                              "scale": np.asarray(v.data.scale, np.float32),
                              "zero_point": None if zp is None else int(zp),
                              "bit_width": v.data.bit_width}
    qps = {name: (np.asarray(qp.scale, np.float32),
                  None if qp.zero_point is None else int(qp.zero_point))
           for name, qp in jq.quant_params.items()}
    return {"constants": consts, "quant_params": qps}


def _setup(lm, seq):
    """Both graphs at ``seq``, token embeddings of seeded ids, the JAX
    QModel (calibrated on 2 sequences) before and after optimize(), and its
    recorded int8 values."""
    if seq in lm["cache"]:
        return lm["cache"][seq]
    b = CASES[seq]
    with jax.enable_x64(False):
        jproto = JL.llama_causal_lm(batch_size=b, seq_len=seq,
                                    module=lm["hf"])
        wte = jproto._wte
        rng = np.random.default_rng(seq)
        calib = wte[rng.integers(0, CFG["vocab_size"], size=(2, seq))]
        x = wte[rng.integers(0, CFG["vocab_size"], size=(b, seq))]
        jm = nq.Model.from_onnx(jproto)
        stats = jm.calibration_stats([calib])
        jfloat = np.asarray(jm([x])[0])
        jq = jm.quantize(bit_width=8, stats=stats)
        state = _jax_state(jq)
        jrep = jq.optimize()
        jy = jq([x], record=True)[0]
        jdata = {v.name: np.asarray(v.data.data) for v in jq.values
                 if isinstance(v, JVariable) and isinstance(v.data, JQTensor)
                 and v.data.bit_width <= 8}
    s = dict(jproto=jproto,
             tproto=TL.llama_causal_lm(lm["weights"], CFG, batch_size=b,
                                       seq_len=seq),
             x=x, calib=calib, stats=stats, jfloat=jfloat, state=state,
             jrep=jrep, jplain=list(jq.fusion_report.get("plain_fusions", [])),
             jnodes={n.name: dict(n.attrs) for n in jq.nodes
                     if n.op == "FusedAttention"},
             jy=np.asarray(jy), jdata=jdata)
    lm["cache"][seq] = s
    return s


def _port_qmodel(s, stats=None):
    tm = Model.from_onnx(s["tproto"], device="cpu")
    return tm.quantize(bit_width=8, stats=stats or s["stats"])


def _graph_signature(proto):
    g = proto.graph
    return ([(n.op_type, list(n.input), list(n.output)) for n in g.node],
            [i.name for i in g.input], [o.name for o in g.output],
            sorted(i.name for i in g.initializer))


def test_random_weights_load_into_hf(lm):
    w = lm["weights"]
    assert set(w) == set(lm["hf"].state_dict())
    assert np.all(w["model.norm.weight"] == 1.0)
    assert abs(float(w["lm_head.weight"].std()) - 0.02) < 2e-3
    with pytest.raises(ValueError, match="tied"):
        TL.llama_causal_lm(w, dict(CFG, tie_word_embeddings=True))


@pytest.mark.parametrize("seq", [16, 1024])
def test_rope_tables_equal_jax(lm, seq):
    """HF's default-RoPE arithmetic on the host, bit for bit."""
    for got, want in zip(TL.rope_tables(CFG, seq),
                         JL._rope_tables(lm["hf"], seq)):
        assert got.shape == want.shape == (1, 1, seq, 16)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_graph_matches_jax_node_for_node(lm):
    """The same nodes, value names, inputs, outputs and initializers, and
    equal initializer payloads."""
    s = _setup(lm, 16)
    assert _graph_signature(s["tproto"]) == _graph_signature(s["jproto"])
    np.testing.assert_array_equal(s["tproto"]._wte, s["jproto"]._wte)
    jinit = {t.name: t for t in s["jproto"].graph.initializer}
    from numpy_quant_tpu import onnx as J_ONNX
    from numpy_quant_tpu_torch import onnx as T_ONNX
    for t in s["tproto"].graph.initializer:
        np.testing.assert_array_equal(T_ONNX.to_array(t),
                                      J_ONNX.to_array(jinit[t.name]),
                                      err_msg=t.name)


def test_float_logits_and_stats_match_jax(lm):
    s = _setup(lm, 16)
    tm = Model.from_onnx(s["tproto"], device="cpu")
    got = tm([s["x"]])[0]
    want = s["jfloat"]
    assert got.shape == (CASES[16], 16, CFG["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with torch.no_grad():
        hf = lm["hf"](inputs_embeds=torch.from_numpy(s["x"])).logits.numpy()
    np.testing.assert_allclose(got, hf, rtol=0, atol=1e-5 * np.abs(hf).max())
    stats = tm.calibration_stats([s["calib"]])
    assert set(stats) == set(s["stats"])
    for name, (mn, mx) in stats.items():
        jmn, jmx = s["stats"][name]
        span = max(abs(float(jmn)), abs(float(jmx)), 1e-30)
        assert abs(float(mn) - float(jmn)) <= 1e-5 * span, name
        assert abs(float(mx) - float(jmx)) <= 1e-5 * span, name


def test_quantize_matches_jax(lm):
    """With JAX's stats, every quantized constant (int8 weights, RMSNorm
    weights, RoPE tables, the 32-bit mask biases) and every qparam is
    equal."""
    s = _setup(lm, 16)
    tq = _port_qmodel(s)
    consts = {v.name: v.data for v in tq.values
              if isinstance(v, Constant) and isinstance(v.data, QTensor)}
    assert set(consts) == set(s["state"]["constants"])
    assert {"rope.cos", "rope.sin", "layers.0.self_attn.causal_mask",
            "layers.1.input_norm.weight"} <= set(consts)
    for name, t in consts.items():
        j = s["state"]["constants"][name]
        assert t.bit_width == j["bit_width"], name
        np.testing.assert_array_equal(t.data.numpy(), j["payload"],
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(t.scale), j["scale"],
                                      err_msg=name)
        assert t.zero_point == j["zero_point"], name
    assert set(tq.quant_params) == set(s["state"]["quant_params"])
    for name, qp in tq.quant_params.items():
        scale, zp = s["state"]["quant_params"][name]
        np.testing.assert_array_equal(np.asarray(qp.scale), scale)
        assert qp.zero_point == zp, name


@pytest.mark.parametrize("seq", [16, 1024])
def test_optimize_report_and_attrs_match_jax(lm, seq):
    """Both layers take the plain fusion (RoPE and repeat_kv sit between
    the head split and the scores): 2 FusedAttention, 0 FusedAttentionHS,
    2 plain fusions, no failures, and JAX's attributes bit for bit."""
    s = _setup(lm, seq)
    tq = _port_qmodel(s)
    trep = tq.optimize()
    print("optimize:", trep)
    for key in trep:
        assert trep[key] == s["jrep"][key], key
    assert trep["fuse_attention"] == LAYERS
    assert trep["fusion_failures"] == []
    assert tq.fusion_report["plain_fusions"] == s["jplain"]
    assert len(s["jplain"]) == LAYERS
    assert not [n for n in tq.nodes if n.op == "FusedAttentionHS"]
    tnodes = {n.name: n.attrs for n in tq.nodes if n.op == "FusedAttention"}
    assert set(tnodes) == set(s["jnodes"]) and len(tnodes) == LAYERS
    for name, attrs in tnodes.items():
        want = s["jnodes"][name]
        assert set(attrs) == set(want), name
        for key in ("scaling", "probs_scale", "score_max"):
            assert np.float32(attrs[key]) == np.float32(want[key]), key
        assert attrs["probs_zero_point"] == want["probs_zero_point"]
        assert np.float32(attrs["causal_mask_val"]).tobytes() \
            == np.float32(want["causal_mask_val"]).tobytes()
        assert attrs["causal_mask_val"] < -1e4
        assert attrs["out_requant"] == tuple(want["out_requant"])
        assert "causal_window" not in attrs


def _hold_against_jax(s, tq, fused, att_expected):
    """The end-to-end contract against the JAX QModel's recorded int8
    values and logits; returns the count of 1-LSB differences."""
    att_names = {n.outputs[0].name for n in tq.nodes
                 if n.op == "FusedAttention"}
    flips = total = att_flips = att_total = 0
    for v in tq.values:
        if not isinstance(v, Variable) or not isinstance(v.data, QTensor) \
                or v.data.bit_width > 8:
            continue
        want = s["jdata"][v.name].astype(np.int64)
        got = v.data.data.numpy().astype(np.int64)
        assert want.shape == got.shape, v.name
        diff = np.abs(want - got)
        assert diff.max(initial=0) <= 1, v.name
        flips += int((diff > 0).sum())
        total += want.size
        if v.name in att_names:
            att_flips += int((diff > 0).sum())
            att_total += want.size
    print(f"int8 intermediates differing by 1 LSB: {flips} of {total}; "
          f"attention outputs {att_flips} of {att_total}")
    assert att_total == att_expected
    assert flips <= 0.001 * total
    jy = s["jy"]
    atol = 1e-4 if flips == 0 else 1e-2 * float(np.abs(jy).max())
    np.testing.assert_allclose(fused, jy, rtol=0, atol=atol)
    return flips


@pytest.mark.parametrize("seq", [16, 1024])
def test_int8_end_to_end(lm, seq, monkeypatch):
    """JAX's quantized state installed in a port QModel calibrated on other
    data: the fused f32 forward equals the unfused one bit for bit, calls
    fused_attention once per layer (the blockwise plain tiles at seq 1024),
    writes int8 (out_requant) and meets the contract against JAX; the bf16
    mode stays finite and close."""
    s = _setup(lm, seq)
    b = CASES[seq]
    tq = _port_qmodel(s, Model.from_onnx(s["tproto"], device="cpu")
                      .calibration_stats([s["calib"] * 2.0]))
    assert load_jax_params(tq, s["state"]) == len(s["state"]["constants"])
    x = s["x"]
    unfused = tq([x])[0]
    tq.optimize()
    tiles = []
    plain = TA.fused_attention_reference
    monkeypatch.setattr(TA, "fused_attention_reference",
                        lambda *a, **k: tiles.append(a[0].shape) or plain(*a, **k))
    before = TA.fused_attention.launches
    fused = tq([x], record=True)[0]
    monkeypatch.undo()
    assert TA.fused_attention.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(fused, unfused)
    heads = CFG["num_attention_heads"]
    assert tiles == [(b * heads, seq, 16)] * LAYERS
    assert TA.blockwise(seq, None) is (seq == 1024)
    for n in tq.nodes:
        if n.op == "FusedAttention":
            assert isinstance(n.outputs[0].data, QTensor)
    _hold_against_jax(s, tq, fused, b * heads * seq * 16 * LAYERS)

    with TC.low_precision_floats():
        bf = tq([x])[0]
    assert bf.dtype == np.float32 and np.isfinite(bf).all()
    err = float(np.abs(bf - fused).max())
    print(f"seq {seq}: bf16 max|bf16 - f32| {err:.3g} of "
          f"{np.abs(fused).max():.3g}")
    assert err <= 0.05 * float(np.abs(fused).max())


def test_port_calibration_end_to_end(lm):
    """The port's own path, calibration included: quantize on its own
    stats, optimize(), fused f32 == unfused bit for bit, and one graph
    built for B=2 serving B=1 (the reshapes copy the batch dim)."""
    s = _setup(lm, 16)
    tm = Model.from_onnx(s["tproto"], device="cpu")
    tq = tm.quantize(bit_width=8, stats=tm.calibration_stats([s["calib"]]))
    unfused = tq([s["x"]])[0]
    one = tq([s["x"][:1]])[0]
    tq.optimize()
    fused = tq([s["x"]])[0]
    np.testing.assert_array_equal(fused, unfused)
    np.testing.assert_array_equal(tq([s["x"][:1]])[0], one)
    np.testing.assert_array_equal(one, unfused[:1])


def test_sliding_window_matches_jax(lm):
    """A Mistral-style sliding_window config bands the mask: the port's
    graph equals JAX's (from a live MistralForCausalLM), causal_window is
    JAX's, and the fused forward equals the unfused one bit for bit."""
    w = lm["weights"]
    hf = _hf(MistralForCausalLM, MistralConfig, w, sliding_window=WINDOW)
    seq, b = 16, 2
    with jax.enable_x64(False):
        jproto = JL.llama_causal_lm(batch_size=b, seq_len=seq, module=hf)
        x = jproto._wte[np.random.default_rng(5).integers(
            0, CFG["vocab_size"], size=(b, seq))]
        jm = nq.Model.from_onnx(jproto)
        stats = jm.calibration_stats([x])
        jq = jm.quantize(bit_width=8, stats=stats)
        jq.optimize()
        jwin = [n.attrs.get("causal_window") for n in jq.nodes
                if n.op == "FusedAttention"]
    tproto = TL.llama_causal_lm(w, dict(CFG, sliding_window=WINDOW),
                                batch_size=b, seq_len=seq)
    assert _graph_signature(tproto) == _graph_signature(jproto)
    tq = Model.from_onnx(tproto, device="cpu").quantize(bit_width=8,
                                                        stats=stats)
    unfused = tq([x])[0]
    rep = tq.optimize()
    assert rep["fuse_attention"] == LAYERS and rep["fusion_failures"] == []
    twin = [n.attrs.get("causal_window") for n in tq.nodes
            if n.op == "FusedAttention"]
    assert twin == jwin == [WINDOW] * LAYERS
    np.testing.assert_array_equal(tq([x])[0], unfused)


@pytest.fixture(scope="module")
def mistral():
    """JAX's mistral_causal_lm (seed 0) and the port's on the same module's
    weights, with its torch module."""
    with jax.enable_x64(False):
        jproto = JL.mistral_causal_lm(batch_size=2, seq_len=16, seed=0)
    hf = jproto._torch_module
    w = {k: v.detach().numpy().copy() for k, v in hf.state_dict().items()}
    return dict(jproto=jproto, hf=hf,
                tproto=TL.mistral_causal_lm(w, batch_size=2, seq_len=16),
                x=np.random.default_rng(9).normal(size=(2, 16, 32))
                .astype(np.float32))


def test_mistral_default_config_and_graph_match_jax(mistral):
    """mistral_default_config carries JAX's MistralConfig fields; the graph
    equals JAX's, and its float logits lie within 2e-5 of the live
    MistralForCausalLM's (JAX's oracle) and 1e-5 * max|logit| of JAX's."""
    hf_cfg = mistral["hf"].config
    for key, val in TL.mistral_default_config().items():
        assert getattr(hf_cfg, key) == val, key
    assert _graph_signature(mistral["tproto"]) == \
        _graph_signature(mistral["jproto"])
    got = Model.from_onnx(mistral["tproto"], device="cpu")([mistral["x"]])[0]
    with torch.no_grad():
        want = mistral["hf"](inputs_embeds=torch.from_numpy(
            mistral["x"])).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    with jax.enable_x64(False):
        jout = np.asarray(nq.Model.from_onnx(mistral["jproto"])(
            [mistral["x"]])[0])
    np.testing.assert_allclose(got, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())
    with pytest.raises(ValueError, match="sliding_window"):
        TL.mistral_causal_lm({}, dict(TL.mistral_default_config(),
                                      sliding_window=None))


def test_mistral_window_fuses_bit_identical(mistral):
    """The banded mask folds into the fused kernels' causal_window (6) in
    both fused attentions, as JAX's; fused == unfused bit for bit."""
    x = mistral["x"]
    tm = Model.from_onnx(mistral["tproto"], device="cpu")
    q = tm.quantize(bit_width=8, stats=tm.calibration_stats([x]))
    base = q([x])[0]
    rep = q.optimize()
    assert rep["fuse_attention"] == 2 and rep["fusion_failures"] == []
    fnodes = [n for n in q.nodes
              if n.op in ("FusedAttention", "FusedAttentionHS")]
    assert [n.attrs.get("causal_window") for n in fnodes] == [6, 6]
    np.testing.assert_array_equal(q([x])[0], base)
