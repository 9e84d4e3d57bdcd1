"""The port's GPT-2 graphs and greedy KV-cache decode held against the JAX
package on a small GPT (2 layers, n_embd 64, 4 heads, vocab 96, 16
positions), in TPU-mode numerics (x64 off). JAX builds its graphs from a
``transformers.GPT2LMHeadModel`` loaded with ``random_gpt2_weights``; the
port builds its own from the same numpy weights.

Tolerances: float logits (the causal LM, one decode step and the prefill
form, whose present K/V too) within 1e-5 * max|value| of JAX's (f32
products summed in another order).
Greedy ``generate_kv`` tokens (prompt 4, 6 new) equal JAX's: float, then
W4 g=8 under packed_execution "unpack" and "kernel", with JAX's
weight-only state installed by ``load_jax_params``. The port's "kernel"
step logits lie within rtol=1e-4, atol=1e-5 of its "unpack" logits, the
JAX package's own bound between its two paths."""
import contextlib
import importlib

import jax
import numpy as np
import pytest
import torch
from transformers import GPT2Config
from transformers.models.gpt2.modeling_gpt2 import GPT2LMHeadModel

import numpy_quant_tpu as nq
from numpy_quant_tpu import config as JC
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.models import gpt as JG
from numpy_quant_tpu.tensor import PackedQTensor as JPackedQTensor
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.kernels import qmatmul as TQ
from numpy_quant_tpu_torch.models import gpt as TG

# the modules: each package's ``generate`` name is the function
TGEN = importlib.import_module("numpy_quant_tpu_torch.utils.generate")
JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

CFG = dict(vocab_size=96, n_positions=16, n_embd=64, n_layer=2, n_head=4)
B, MAX_LEN, SEQ, PREFILL = 2, 16, 12, 8
PROMPT, NEW = 4, 6
WO_PER_STEP = 4 * CFG["n_layer"] + 1  # c_attn, c_proj, c_fc, c_proj; head


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@contextlib.contextmanager
def packed_execution(mode):
    prev = JC.packed_execution, TC.packed_execution
    JC.packed_execution = TC.packed_execution = mode
    try:
        yield
    finally:
        JC.packed_execution, TC.packed_execution = prev


@pytest.fixture(scope="module")
def gpt():
    weights = TG.random_gpt2_weights(CFG, seed=0)
    hf = GPT2LMHeadModel(GPT2Config(**CFG, activation_function="gelu",
                                    attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    rng = np.random.default_rng(3)
    with jax.enable_x64(False):
        j_step = JG.gpt_decode_step(module=hf, batch_size=B, max_len=MAX_LEN)
        j_lm = JG.gpt_causal_lm(module=hf, batch_size=B, seq_len=SEQ)
        j_prefill = JG.gpt_prefill(prefill_len=PREFILL, module=hf)
    return dict(
        weights=weights, hf=hf, j_step=j_step, j_lm=j_lm,
        j_prefill=j_prefill,
        t_prefill=TG.gpt_prefill(weights, CFG, prefill_len=PREFILL),
        t_step=TG.gpt_decode_step(weights, CFG, batch_size=B,
                                  max_len=MAX_LEN),
        t_lm=TG.gpt_causal_lm(weights, CFG, batch_size=B, seq_len=SEQ),
        prompt=rng.integers(0, CFG["vocab_size"],
                            size=(B, PROMPT)).astype(np.int32))


def _graph_signature(proto):
    g = proto.graph
    return ([(n.op_type, list(n.input), list(n.output)) for n in g.node],
            [i.name for i in g.input], [o.name for o in g.output],
            sorted(i.name for i in g.initializer))


@pytest.mark.parametrize("form", ["step", "lm", "prefill"])
def test_graphs_match_jax_node_for_node(gpt, form):
    """The same nodes, value names, inputs, outputs and initializers."""
    jp, tp = gpt[f"j_{form}"], gpt[f"t_{form}"]
    assert _graph_signature(tp) == _graph_signature(jp)
    np.testing.assert_array_equal(tp._wte, jp._wte)
    np.testing.assert_array_equal(tp._wpe, jp._wpe)


def test_random_weights_tie_the_head_and_load_into_hf(gpt):
    w = gpt["weights"]
    assert w["lm_head.weight"] is w["transformer.wte.weight"]
    assert set(w) == set(gpt["hf"].state_dict())
    with pytest.raises(ValueError, match="GELU"):
        TG.gpt_decode_step(w, dict(CFG, activation_function="gelu_new"))


def test_causal_lm_logits_match_jax_and_hf(gpt):
    x = np.random.default_rng(1).normal(
        size=(B, SEQ, CFG["n_embd"])).astype(np.float32) * 0.1
    want = np.asarray(nq.Model.from_onnx(gpt["j_lm"])([x])[0])
    got = Model.from_onnx(gpt["t_lm"], device="cpu")([x])[0]
    assert got.shape == (B, SEQ, CFG["vocab_size"])
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    with torch.no_grad():
        hf = gpt["hf"](inputs_embeds=torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(got, hf, rtol=0, atol=tol)


def test_prefill_logits_and_presents_match_jax(gpt):
    """gpt_prefill over a prompt padded to P: logits and every layer's
    present K/V [1, heads, P, head] within 1e-5 * max|value| of JAX's, and
    the live rows equal to the causal LM's."""
    x = np.random.default_rng(2).normal(
        size=(1, PREFILL, CFG["n_embd"])).astype(np.float32) * 0.1
    want = [np.asarray(o) for o in nq.Model.from_onnx(gpt["j_prefill"])([x])]
    got = Model.from_onnx(gpt["t_prefill"], device="cpu")([x])
    nh, hd = CFG["n_head"], CFG["n_embd"] // CFG["n_head"]
    assert len(got) == 1 + 2 * CFG["n_layer"]
    assert got[0].shape == (1, PREFILL, CFG["vocab_size"])
    assert all(g.shape == (1, nh, PREFILL, hd) for g in got[1:])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    lm = TG.gpt_causal_lm(gpt["weights"], CFG, batch_size=1,
                          seq_len=PREFILL)
    np.testing.assert_allclose(
        got[0], Model.from_onnx(lm, device="cpu")([x])[0], rtol=0,
        atol=1e-5 * np.abs(got[0]).max())


def _step_inputs(seed, t=5):
    """One decode step's inputs at position t: x_step, the mask, caches
    filled below t."""
    rng = np.random.default_rng(seed)
    nh, hd = CFG["n_head"], CFG["n_embd"] // CFG["n_head"]
    x = rng.normal(size=(B, 1, CFG["n_embd"])).astype(np.float32) * 0.1
    caches = []
    for _ in range(2 * CFG["n_layer"]):
        c = np.zeros((B, nh, MAX_LEN, hd), np.float32)
        c[:, :, :t] = rng.normal(size=(B, nh, t, hd))
        caches.append(c)
    return [x, TGEN._step_mask(t, MAX_LEN)] + caches


def test_step_mask_matches_jax():
    for t in (0, 3, MAX_LEN):
        np.testing.assert_array_equal(
            TGEN._step_mask(t, MAX_LEN),
            np.asarray(JGEN._step_mask(t, MAX_LEN)))


def test_decode_step_logits_match_jax(gpt):
    ins = _step_inputs(seed=2)
    want = [np.asarray(o) for o in nq.Model.from_onnx(gpt["j_step"])(ins)]
    got = Model.from_onnx(gpt["t_step"], device="cpu")(ins)
    assert len(got) == len(want) == 1 + 2 * CFG["n_layer"]
    assert got[0].shape == (B, 1, CFG["vocab_size"])
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        np.testing.assert_allclose(g_, w_, rtol=0,
                                   atol=1e-5 * np.abs(w_).max())


def _jax_weight_only_state(jm):
    """JAX's weight-only constants as load_jax_params takes them."""
    consts = {}
    for v in jm.values:
        if isinstance(v, JConstant) and isinstance(v.data, JPackedQTensor):
            p = v.data
            consts[v.name] = {"layout": p.layout, "k": p.k, "n": p.n,
                              "bit_width": p.bit_width,
                              "scale": np.asarray(p.scale, np.float32),
                              "payload": np.asarray(p.planes),
                              "colsum": np.asarray(p.colsum)}
        elif isinstance(v, JConstant) and isinstance(v.data, JQTensor):
            consts[v.name] = {"payload": np.asarray(v.data.data),
                              "scale": np.asarray(v.data.scale, np.float32),
                              "zero_point": None,
                              "bit_width": v.data.bit_width}
    return {"constants": consts}


def _decode_pair(gpt, mode, quant):
    """(JAX ids, port ids, port model) of one greedy decode under
    packed_execution=mode; quant is None (float) or quantize_weights
    keyword arguments."""
    jm = nq.Model.from_onnx(gpt["j_step"])
    tm = Model.from_onnx(gpt["t_step"], device="cpu")
    if quant is not None:
        assert jm.quantize_weights(**quant) == WO_PER_STEP
        assert tm.quantize_weights(**quant) == WO_PER_STEP
        assert load_jax_params(tm, _jax_weight_only_state(jm)) \
            == WO_PER_STEP
    jp = gpt["j_step"]
    with packed_execution(mode):
        want = JGEN.generate_kv(jm, gpt["prompt"], jp._wte, jp._wpe, NEW)
        got = TGEN.generate_kv(tm, gpt["prompt"], gpt["t_step"]._wte,
                               gpt["t_step"]._wpe, NEW)
    return np.asarray(want), got, tm


W4G8 = dict(bit_width=4, group_size=8)


@pytest.mark.parametrize("mode,quant", [
    ("unpack", None), ("unpack", W4G8), ("kernel", W4G8),
    ("kernel", dict(bit_width=8)), ("kernel", dict(bit_width=2,
                                                   group_size=16))],
    ids=["float", "w4g8-unpack", "w4g8-kernel", "w8-kernel",
         "w2g16-kernel"])
def test_generate_kv_tokens_match_jax(gpt, mode, quant):
    want, got, _ = _decode_pair(gpt, mode, quant)
    assert got.dtype == np.int32 and got.shape == (B, PROMPT + NEW)
    np.testing.assert_array_equal(got[:, :PROMPT], gpt["prompt"])
    np.testing.assert_array_equal(got, want)


def test_kernel_route_and_logits_against_unpack(gpt, monkeypatch):
    """Under "kernel" every packed weight-only MatMul of the step goes
    through splitk_wo_matmul (9 per step), under "unpack" none does; the
    logits agree within the JAX package's bound between its two paths."""
    tm = Model.from_onnx(gpt["t_step"], device="cpu")
    tm.quantize_weights(**W4G8)
    calls = []
    wrapped = TQ.splitk_wo_matmul

    def counting(*args, **kwargs):
        calls.append(args[1].shape)
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(TQ, "splitk_wo_matmul", counting)
    ins = _step_inputs(seed=4)
    with packed_execution("unpack"):
        unpack = tm(ins)
    assert calls == []
    with packed_execution("kernel"):
        kernel = tm(ins)
    assert len(calls) == WO_PER_STEP
    for k_, u_ in zip(kernel, unpack):
        np.testing.assert_allclose(k_, u_, rtol=1e-4, atol=1e-5)


def test_generate_kv_keeps_every_step_logits(gpt):
    """generate_kv hands out one logits row per step; past the prompt each
    row's argmax is the next id."""
    _, got, tm = _decode_pair(gpt, "unpack", None)
    rows = []
    ids = TGEN.generate_kv(tm, gpt["prompt"], gpt["t_step"]._wte,
                           gpt["t_step"]._wpe, NEW, step_logits=rows)
    np.testing.assert_array_equal(ids, got)
    assert len(rows) == PROMPT + NEW - 1
    for t, row in enumerate(rows):
        assert row.shape == (B, CFG["vocab_size"])
        assert row.dtype == torch.float32
        if t + 1 >= PROMPT:
            np.testing.assert_array_equal(row.argmax(-1).numpy(),
                                          ids[:, t + 1])


@pytest.mark.parametrize("option,value", [
    ("score_bias", 1), ("memory", 1), ("key", 0)])
def test_unported_options_raise(gpt, option, value):
    """The T5 and seq2seq step forms' arguments need a step graph with
    their inputs (GPT-2's has none); a JAX PRNG key is refused in favour of
    generator=."""
    tm = Model.from_onnx(gpt["t_step"], device="cpu")
    error = NotImplementedError if option == "key" else ValueError
    with pytest.raises(error, match="layout|generator="):
        TGEN.generate_kv(tm, gpt["prompt"], gpt["t_step"]._wte,
                         gpt["t_step"]._wpe, NEW, **{option: value})


class _JaxNoise:
    """JAX's generate_kv per-step Gumbel draws (one key split per step),
    handed to the port's sampler in order."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape, generator):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))


def _tiny_llama_step():
    """(JAX step proto, port step proto) of a 2-layer LLaMA on the same
    weights (RoPE and grouped-query caches)."""
    from transformers import LlamaConfig
    from transformers.models.llama.modeling_llama import LlamaForCausalLM
    from numpy_quant_tpu.models import llama as JL
    from numpy_quant_tpu_torch.models import llama as TL
    cfg = dict(vocab_size=96, hidden_size=64, intermediate_size=96,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64,
               tie_word_embeddings=False)
    weights = TL.random_llama_weights(cfg, seed=0)
    hf = LlamaForCausalLM(LlamaConfig(**cfg, attn_implementation="eager"))
    hf.eval().load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    with jax.enable_x64(False):
        jp = JL.llama_decode_step(batch_size=B, max_len=MAX_LEN, module=hf)
    return jp, TL.llama_decode_step(weights, cfg, batch_size=B,
                                    max_len=MAX_LEN)


@pytest.mark.parametrize("option,value", [
    ("kv_cache_dtype", "int8"), ("rope", None), ("temperature", 0.7),
    ("top_k", 5), ("top_p", 0.9), ("min_p", 0.1),
    ("repetition_penalty", 1.2)])
def test_ported_options_match_jax(gpt, option, value, monkeypatch):
    """The options the port once refused decode as JAX's generate_kv does:
    an int8 cache on the float step raises JAX's ValueError and on the
    int8 step gives JAX's tokens; rope= decodes a LLaMA step; the sampling
    knobs draw JAX's per-step noise and pick JAX's tokens;
    repetition_penalty equals JAX's greedy pick."""
    jp, tp = gpt["j_step"], gpt["t_step"]
    jm, tm = nq.Model.from_onnx(jp), Model.from_onnx(tp, device="cpu")
    args = (gpt["prompt"],)
    jwpe, twpe, kw = jp._wpe, tp._wpe, {option: value}
    if option == "kv_cache_dtype":
        for gen, model, proto in ((JGEN, jm, jp), (TGEN, tm, tp)):
            with pytest.raises(ValueError, match="quantized step model"):
                gen.generate_kv(model, *args, proto._wte, proto._wpe, NEW,
                                **kw)
        batches = JGEN.decode_calibration(jm, gpt["prompt"], jp._wte, jwpe)
        stats = nq.utils.merge_calibration_stats(
            *[jm.calibration_stats(b) for b in batches])
        jm, tm = (m.quantize(stats=stats, bit_width=8) for m in (jm, tm))
    elif option == "rope":
        jp, tp = _tiny_llama_step()
        jm, tm = nq.Model.from_onnx(jp), Model.from_onnx(tp, device="cpu")
        jwpe = twpe = None
        kw = {"rope": jp._rope_tables}
    elif option != "repetition_penalty":
        key = jax.random.PRNGKey(2)
        monkeypatch.setattr(TGEN, "_gumbel", _JaxNoise(key))
        kw = dict(kw, key=key)
    want = np.asarray(JGEN.generate_kv(jm, *args, jp._wte, jwpe, NEW, **kw))
    kw.pop("key", None)
    if option == "rope":
        kw = {"rope": tp._rope_tables}
    got = TGEN.generate_kv(tm, *args, tp._wte, twpe, NEW, **kw)
    np.testing.assert_array_equal(got, want)


def test_generate_kv_refuses_too_long_and_wrong_batch(gpt):
    tm = Model.from_onnx(gpt["t_step"], device="cpu")
    p = gpt["t_step"]
    with pytest.raises(ValueError, match="cache length"):
        TGEN.generate_kv(tm, gpt["prompt"], p._wte, p._wpe, MAX_LEN)
    with pytest.raises(ValueError, match="batch"):
        TGEN.generate_kv(tm, gpt["prompt"][:1], p._wte, p._wpe, NEW)
