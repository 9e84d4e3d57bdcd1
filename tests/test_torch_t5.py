"""The port's T5 encoder-decoder (relative position bias, unscaled
attention, T5LayerNorm, tied and rescaled LM head) held against the live
``transformers`` module and the JAX package on JAX's tiny config (d_model
32, 4 heads, d_kv 8, d_ff 48, 2 + 2 layers, 8 buckets, vocab 96), in
TPU-mode numerics (x64 off). JAX builds its graphs from the module; the
port builds its own from the module's ``state_dict()`` as numpy.

Tolerances: the host relative bias equals HF's ``compute_bias`` and the
graphs equal JAX's, node for node, with equal initializers. Float outputs
lie within atol 2e-5 of the module's (the oracle of tests/test_t5.py) and
within 1e-5 * max|output| of JAX's. The ``optimize()`` reports equal JAX's
(2 fused for the encoder; 6 for the full model, 4 of them with the bias as
4th input), and the fused f32 forward equals the unfused one bit for bit.
With JAX's quantized state installed (``load_jax_params``), the attention
outputs equal JAX's int8 for int8 and every other int8 intermediate
differs by at most 1 LSB on at most 0.1% of entries, where a float op
(an RMSNorm mean, exp) rounds across a rint boundary in another order (the
count is printed); logits agree within 1e-4 when none differs, else within
1e-2 * max|logit|. This holds at S=12, T=8 and at S=512 on a one-layer
config, where the bias clause sends the encoder blockwise on both sides.
The gated-GELU variant (Tanh, whose last ulp XLA's CPU tanh and torch's
may round apart) lies within 2e-5 of the module and 1e-5 * max|logit| of
JAX. The bf16 serving mode is finite and within 5% of max|logit| of f32.
"""
import jax
import numpy as np
import pytest
import torch
from transformers import T5Config, T5ForConditionalGeneration
from transformers.models.t5.modeling_t5 import T5Attention

import numpy_quant_tpu as nq
from numpy_quant_tpu import onnx as J_ONNX
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.graph import Variable as JVariable
from numpy_quant_tpu.models import t5 as JT
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch import onnx as T_ONNX
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.graph import Constant, Variable
from numpy_quant_tpu_torch.kernels import attention as TA
from numpy_quant_tpu_torch.models import t5 as TT
from numpy_quant_tpu_torch.tensor import QTensor, quantize_tensor

B, S, T = 2, 12, 8


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _port_cfg(hf_config) -> dict:
    return {k: getattr(hf_config, k) for k in TT.T5_SMALL}


def _module(config) -> T5ForConditionalGeneration:
    torch.manual_seed(0)
    return T5ForConditionalGeneration(config).eval()


def _state(module) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def t5():
    hf = _module(JT.default_config(max(S, T)))
    return dict(hf=hf, w=_state(hf), cfg=_port_cfg(hf.config), cache={})


def _graph_signature(proto):
    g = proto.graph
    return ([(n.op_type, list(n.input), list(n.output)) for n in g.node],
            [i.name for i in g.input], [o.name for o in g.output],
            sorted(i.name for i in g.initializer))


def _same_graph(tproto, jproto):
    assert _graph_signature(tproto) == _graph_signature(jproto)
    jinit = {t.name: t for t in jproto.graph.initializer}
    for t in tproto.graph.initializer:
        np.testing.assert_array_equal(T_ONNX.to_array(t),
                                      J_ONNX.to_array(jinit[t.name]),
                                      err_msg=t.name)
    np.testing.assert_array_equal(tproto._wte, jproto._wte)


@pytest.mark.parametrize("buckets,distance", [(8, 12), (32, 128)])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("q_len,k_len", [(12, 12), (8, 12), (128, 128),
                                         (128, 512), (512, 512)])
def test_relative_bias_equals_compute_bias(buckets, distance, bidirectional,
                                           q_len, k_len):
    """The host bucket arithmetic (float32 log, truncation) gathers the
    same bias as HF's compute_bias, bit for bit."""
    config = T5Config(d_model=32, d_kv=8, num_heads=4,
                      relative_attention_num_buckets=buckets,
                      relative_attention_max_distance=distance,
                      is_decoder=not bidirectional)
    torch.manual_seed(buckets)
    attn = T5Attention(config, has_relative_attention_bias=True).eval()
    with torch.no_grad():
        want = attn.compute_bias(q_len, k_len).numpy()
    table = attn.relative_attention_bias.weight.detach().numpy()
    got = TT.relative_position_bias(table, _port_cfg(config), q_len, k_len,
                                    bidirectional)
    assert got.dtype == np.float32 and got.shape == (1, 4, q_len, k_len)
    np.testing.assert_array_equal(got, want)


def test_random_weights_load_into_hf():
    """random_t5_weights is an HF state dict with HF's init scales."""
    config = JT.default_config(12)
    w = TT.random_t5_weights(_port_cfg(config), seed=0)
    hf = T5ForConditionalGeneration(config).eval()
    assert set(w) == set(hf.state_dict())
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    assert w["lm_head.weight"] is w["shared.weight"]
    assert np.all(w["decoder.final_layer_norm.weight"] == 1.0)
    assert abs(float(w["shared.weight"].std()) - 1.0) < 0.05
    q = w["encoder.block.0.layer.0.SelfAttention.q.weight"]
    assert abs(float(q.std()) * (32 * 8) ** 0.5 - 1.0) < 0.1
    small = TT.random_t5_weights({}, seed=0)
    assert small["shared.weight"].shape == (32128, 512)
    assert small["encoder.block.5.layer.1.DenseReluDense.wi.weight"].shape \
        == (2048, 512)
    with pytest.raises(ValueError, match="feed_forward_proj"):
        TT.random_t5_weights({"feed_forward_proj": "gelu"})


def test_encoder_graph_and_float_match(t5):
    """The encoder graph equals JAX's; its float output matches the module
    and JAX."""
    with jax.enable_x64(False):
        jproto = JT.t5_encoder(batch_size=B, seq_len=S,
                               module=_encoder_module(t5))
    tproto = TT.t5_encoder(t5["w"], t5["cfg"], batch_size=B, seq_len=S)
    _same_graph(tproto, jproto)
    x = np.random.default_rng(1).normal(size=(B, S, 32)).astype(np.float32)
    got = Model.from_onnx(tproto, device="cpu")([x])[0]
    with torch.no_grad():
        want = t5["hf"].encoder(inputs_embeds=torch.from_numpy(x)) \
            .last_hidden_state.numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    with jax.enable_x64(False):
        jout = np.asarray(nq.Model.from_onnx(jproto)([x])[0])
    np.testing.assert_allclose(got, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())


def _encoder_module(t5):
    """A T5EncoderModel sharing the full module's encoder weights (JAX's
    encoder builder reads one)."""
    from transformers import T5EncoderModel
    enc = T5EncoderModel(t5["hf"].config).eval()
    enc.load_state_dict({k: v for k, v in t5["hf"].state_dict().items()
                         if k == "shared.weight" or k.startswith("encoder.")})
    return enc


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


def _setup(hf, w, cfg, s_len, t_len, b=B):
    """Both full graphs, token embeddings of seeded ids through ``shared``
    (2 calibration sequences, then the scored batch), the JAX QModel
    before and after optimize() and its recorded int8 values."""
    vocab = cfg["vocab_size"]
    with jax.enable_x64(False):
        jproto = JT.t5_conditional_generation(batch_size=b, src_len=s_len,
                                              tgt_len=t_len, module=hf)
        wte = jproto._wte
        rng = np.random.default_rng(s_len)
        calib = [wte[rng.integers(0, vocab, size=(2, n))]
                 for n in (s_len, t_len)]
        x = [wte[rng.integers(0, vocab, size=(b, n))] for n in (s_len, t_len)]
        jm = nq.Model.from_onnx(jproto)
        stats = jm.calibration_stats(calib)
        jfloat = np.asarray(jm(x)[0])
        jq = jm.quantize(bit_width=8, stats=stats)
        state = _jax_state(jq)
        jrep = jq.optimize()
        jy = jq(x, record=True)[0]
        jdata = {v.name: np.asarray(v.data.data) for v in jq.values
                 if isinstance(v, JVariable) and isinstance(v.data, JQTensor)
                 and v.data.bit_width <= 8}
        jfused = [(n.name, len(n.inputs)) for n in jq.nodes
                  if n.op == "FusedAttentionHS"]
    return dict(jproto=jproto, x=x, calib=calib, stats=stats, jfloat=jfloat,
                state=state, jrep=jrep, jy=np.asarray(jy), jdata=jdata,
                jfused=jfused,
                tproto=TT.t5_conditional_generation(w, cfg, batch_size=b,
                                                    src_len=s_len,
                                                    tgt_len=t_len))


def _full(t5):
    if "full" not in t5["cache"]:
        t5["cache"]["full"] = _setup(t5["hf"], t5["w"], t5["cfg"], S, T)
    return t5["cache"]["full"]


def test_full_graph_and_float_match(t5):
    """The full graph equals JAX's; its float logits match the module and
    JAX, and the port's calibration stats lie within 1e-5 relative of
    JAX's."""
    s = _full(t5)
    _same_graph(s["tproto"], s["jproto"])
    tm = Model.from_onnx(s["tproto"], device="cpu")
    got = tm(s["x"])[0]
    assert got.shape == (B, T, t5["cfg"]["vocab_size"])
    with torch.no_grad():
        want = t5["hf"](inputs_embeds=torch.from_numpy(s["x"][0]),
                        decoder_inputs_embeds=torch.from_numpy(s["x"][1])) \
            .logits.numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, s["jfloat"], rtol=0,
                               atol=1e-5 * np.abs(s["jfloat"]).max())
    stats = tm.calibration_stats(s["calib"])
    assert set(stats) == set(s["stats"])
    for name, (mn, mx) in stats.items():
        jmn, jmx = s["stats"][name]
        span = max(abs(float(jmn)), abs(float(jmx)), 1e-30)
        assert abs(float(mn) - float(jmn)) <= 1e-5 * span, name
        assert abs(float(mx) - float(jmx)) <= 1e-5 * span, name


def test_quantize_carries_the_bias_constants_like_jax(t5):
    """With JAX's stats, every quantized constant -- the encoder bias and
    the decoder's combined constant among them, 32-bit on the scores'
    scale, the latter clipped at -2^31 -- equals JAX's, and
    load_jax_params installs JAX's byte for byte."""
    s = _full(t5)
    tq = Model.from_onnx(s["tproto"], device="cpu").quantize(
        bit_width=8, stats=s["stats"])
    consts = {v.name: v.data for v in tq.values
              if isinstance(v, Constant) and isinstance(v.data, QTensor)}
    assert set(consts) == set(s["state"]["constants"])
    for name in ("encoder.rel_bias", "decoder.rel_bias_masked"):
        assert consts[name].bit_width == 32
    assert int(consts["decoder.rel_bias_masked"].data.min()) == -2 ** 31
    for name, t in consts.items():
        j = s["state"]["constants"][name]
        assert t.bit_width == j["bit_width"], name
        np.testing.assert_array_equal(t.data.numpy(), j["payload"],
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(t.scale), j["scale"],
                                      err_msg=name)
        assert t.zero_point == j["zero_point"], name
    other = Model.from_onnx(s["tproto"], device="cpu").quantize(
        bit_width=8, stats=Model.from_onnx(s["tproto"], device="cpu")
        .calibration_stats([c * 3.0 for c in s["calib"]]))
    assert load_jax_params(other, s["state"]) == len(consts)
    for v in other.values:
        if v.name in ("encoder.rel_bias", "decoder.rel_bias_masked"):
            assert v.data.data.numpy().tobytes() == \
                s["state"]["constants"][v.name]["payload"] \
                .astype(np.int32).tobytes()


def test_encoder_optimize_matches_jax(t5):
    """The encoder's two Softmaxes fuse through the head-split pattern with
    the bias constant as 4th input, as JAX's; fused == unfused."""
    enc = _encoder_module(t5)
    x = np.random.default_rng(2).normal(size=(B, S, 32)).astype(np.float32)
    with jax.enable_x64(False):
        jq = nq.Model.from_onnx(JT.t5_encoder(batch_size=B, seq_len=S,
                                              module=enc))
        stats = jq.calibration_stats([x])
        jrep = jq.quantize(bit_width=8, stats=stats).optimize()
    tq = Model.from_onnx(TT.t5_encoder(t5["w"], t5["cfg"], batch_size=B,
                                       seq_len=S),
                         device="cpu").quantize(bit_width=8, stats=stats)
    unfused = tq([x])[0]
    rep = tq.optimize()
    assert rep == {key: jrep[key] for key in rep}
    assert rep["fuse_attention"] == 2 and rep["fusion_failures"] == []
    fnodes = [n for n in tq.nodes if n.op == "FusedAttentionHS"]
    assert [len(n.inputs) for n in fnodes] == [4, 4]
    np.testing.assert_array_equal(tq([x])[0], unfused)


def test_full_optimize_matches_jax(t5):
    """6 FusedAttentionHS (2 encoder self, 2 decoder self, 2 cross), 4 with
    the bias as 4th input; the report equals JAX's."""
    s = _full(t5)
    tq = Model.from_onnx(s["tproto"], device="cpu").quantize(
        bit_width=8, stats=s["stats"])
    rep = tq.optimize()
    assert rep == {key: s["jrep"][key] for key in rep}
    assert rep["fuse_attention"] == 6 and rep["fusion_failures"] == []
    assert tq.fusion_report.get("plain_fusions", []) == []
    fused = [(n.name, len(n.inputs)) for n in tq.nodes
             if n.op == "FusedAttentionHS"]
    assert fused == s["jfused"]
    assert sum(k == 4 for _, k in fused) == 4
    for n in tq.nodes:
        if n.op == "FusedAttentionHS" and ".cross" in n.name:
            assert n.attrs["scaling"] == 1.0 and len(n.inputs) == 3


def test_accumulator_operands_narrow_as_the_unfused_graph(t5):
    """A FusedAttentionHS operand stands where the head-split Reshape
    dequantized the projection's accumulator and the score MatMul quantized
    the floats (x / scale): QModel._narrow hands it over so, and any other
    quantized consumer the reference's requantize (x * (1 / scale)).
    Accumulators beside every rounding boundary, where the two part, pin
    the rule."""
    s = _full(t5)
    tq = Model.from_onnx(s["tproto"], device="cpu").quantize(
        bit_width=8, stats=s["stats"])
    tq.optimize()
    value = next(v for v in tq.values
                 if v.name == "encoder.block.0.attn.q/MatMul_out")
    fused = next(n for n in tq.nodes if value in n.inputs)
    assert fused.op == "FusedAttentionHS"
    matmul = next(n for n in tq.nodes if n.op == "MatMul")
    qp = tq.quant_params[value.name]
    # accumulators a few steps from every rounding boundary k + 0.5
    steps = 100_000
    ints = np.concatenate([np.round((k + 0.5) * steps) + np.arange(-3, 4)
                           for k in range(-128, 127)]).astype(np.int32)
    acc = QTensor(torch.from_numpy(ints), 32,
                  np.float32(np.float32(qp.scale) / np.float32(steps)), None)
    via_float = quantize_tensor(acc.dequantize(), 8, qp.scale, qp.zero_point)
    requant = acc.requantize(8, qp.scale, qp.zero_point)
    assert int((via_float.data != requant.data).sum()) > 0
    np.testing.assert_array_equal(
        tq._narrow(acc, value, fused).data.numpy(), via_float.data.numpy())
    np.testing.assert_array_equal(tq._narrow(acc, value, matmul).data.numpy(),
                                  requant.data.numpy())


def _hold_against_jax(s, tq, fused):
    """The int8 intermediates and logits against the JAX QModel's; returns
    (1-LSB differences, entries)."""
    att_names = {n.outputs[0].name for n in tq.nodes
                 if n.op == "FusedAttentionHS"}
    flips = total = att_flips = 0
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
    print(f"int8 intermediates differing by 1 LSB: {flips} of {total}; "
          f"attention outputs {att_flips}")
    assert att_flips == 0
    assert flips <= 0.001 * total
    jy = s["jy"]
    atol = 1e-4 if flips == 0 else 1e-2 * float(np.abs(jy).max())
    np.testing.assert_allclose(fused, jy, rtol=0, atol=atol)
    return flips, total


def _int8_end_to_end(s, monkeypatch, want_calls):
    """JAX's quantized state in a port QModel calibrated on other data:
    fused == unfused bit for bit, the wrappers ``want_calls``, the
    contract against JAX, and the bf16 mode."""
    tm = Model.from_onnx(s["tproto"], device="cpu")
    tq = tm.quantize(bit_width=8, stats=tm.calibration_stats(
        [c * 2.0 for c in s["calib"]]))
    assert load_jax_params(tq, s["state"]) == len(s["state"]["constants"])
    unfused = tq(s["x"])[0]
    tq.optimize()
    calls = []
    for fn in ("fused_attention_hs_monolithic", "fused_attention_hs_blockq"):
        wrapped = getattr(TA, fn)
        monkeypatch.setattr(TA, fn, lambda *a, _w=wrapped, _n=fn, **k:
                            calls.append((_n, k["score_bias"] is not None))
                            or _w(*a, **k))
    fused = tq(s["x"], record=True)[0]
    monkeypatch.undo()
    np.testing.assert_array_equal(fused, unfused)
    assert sorted(calls) == sorted(want_calls)
    _hold_against_jax(s, tq, fused)
    with TC.low_precision_floats():
        bf = tq(s["x"])[0]
    assert bf.dtype == np.float32 and np.isfinite(bf).all()
    err = float(np.abs(bf - fused).max())
    print(f"bf16 max|bf16 - f32| {err:.3g} of {np.abs(fused).max():.3g}")
    assert err <= 0.05 * float(np.abs(fused).max())


def test_int8_end_to_end(t5, monkeypatch):
    """S=12, T=8: every attention runs the monolithic wrapper (4 with a
    bias, 2 cross without)."""
    mono = "fused_attention_hs_monolithic"
    _int8_end_to_end(_full(t5), monkeypatch,
                     [(mono, True)] * 4 + [(mono, False)] * 2)


def test_int8_end_to_end_blockwise_encoder(monkeypatch):
    """S=512 on a one-layer config: the encoder bias [4, 512, 512] passes
    2 MiB, so both packages run the encoder blockwise (JAX in interpret
    mode); the decoder self- and cross-attention stay monolithic."""
    config = JT.default_config(512)
    config.num_layers = config.num_decoder_layers = 1
    hf = _module(config)
    cfg = _port_cfg(hf.config)
    assert TA.blockwise(512, None, nq=512, bias_heads=4)
    s = _setup(hf, _state(hf), cfg, 512, T, b=1)
    _int8_end_to_end(s, monkeypatch, [("fused_attention_hs_blockq", True),
                                      ("fused_attention_hs_monolithic", True),
                                      ("fused_attention_hs_monolithic", False)])


def test_gated_gelu_variant():
    """T5 v1.1's gated-GELU feed-forward (Tanh) with an untied LM head:
    the graph equals JAX's, float logits match the module and JAX within
    the stated tolerances, and the quantized fused forward equals the
    unfused one."""
    config = JT.default_config(12)
    config.feed_forward_proj = "gated-gelu"
    config.dense_act_fn, config.is_gated_act = "gelu_new", True
    config.tie_word_embeddings = False
    hf = _module(config)
    cfg = _port_cfg(hf.config)
    w = _state(hf)
    assert set(w) == set(TT.random_t5_weights(cfg, seed=1))
    s = _setup(hf, w, cfg, S, T)
    _same_graph(s["tproto"], s["jproto"])
    assert any(n.op_type == "Tanh" for n in s["tproto"].graph.node)
    tm = Model.from_onnx(s["tproto"], device="cpu")
    got = tm(s["x"])[0]
    with torch.no_grad():
        want = hf(inputs_embeds=torch.from_numpy(s["x"][0]),
                  decoder_inputs_embeds=torch.from_numpy(s["x"][1])) \
            .logits.numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, s["jfloat"], rtol=0,
                               atol=1e-5 * np.abs(s["jfloat"]).max())
    tq = tm.quantize(bit_width=8, stats=s["stats"])
    unfused = tq(s["x"])[0]
    assert tq.optimize()["fuse_attention"] == 6
    np.testing.assert_array_equal(tq(s["x"])[0], unfused)
