"""The port's full-sequence generators (``utils/generate.py::generate``,
``beam_search``, ``generate_speculative``) held against the JAX package's on
tiny GPT-2 (2 layers, n_embd 64, 4 heads, vocab 96) and LLaMA (2 layers,
hidden 64, 4 heads, 2 KV heads, vocab 128) causal graphs of length 24,
float and int8 (both packages quantized with JAX's calibration stats), in
TPU-mode numerics (x64 off). JAX builds its graphs from ``transformers``
modules loaded with the port's random weights.

Tolerances: token ids are equal (zero tolerance) -- greedy, with the
repetition penalty, sampled (the port's noise patched to hand out JAX's
per-step draws), beams and speculative decodes; the verify rounds of a
speculative decode equal JAX's. Beam scores lie within 1e-5 relative of
JAX's (f32 log-softmax sums in another order). The candidate pick of beam
search equals ``lax.top_k``'s on rows with ties and signed zeros.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from transformers import GPT2Config, LlamaConfig
from transformers.models.gpt2.modeling_gpt2 import GPT2LMHeadModel
from transformers.models.llama.modeling_llama import LlamaForCausalLM

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import gpt as JG
from numpy_quant_tpu.models import llama as JL
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.models import gpt as TG
from numpy_quant_tpu_torch.models import llama as TL

# the modules: each package's ``generate`` name is the function
TGEN = importlib.import_module("numpy_quant_tpu_torch.utils.generate")
JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

LEN, B, PROMPT, NEW, W = 24, 2, 4, 12, 3
GPT_CFG = dict(vocab_size=96, n_positions=LEN, n_embd=64, n_layer=2,
               n_head=4)
LLAMA_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=1024,
                 rms_norm_eps=1e-5, rope_theta=10000.0,
                 initializer_range=0.02, tie_word_embeddings=False)


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _hf(arch: str, weights: dict):
    if arch == "gpt":
        hf = GPT2LMHeadModel(GPT2Config(**GPT_CFG, activation_function="gelu",
                                        attn_implementation="eager"))
    else:
        hf = LlamaForCausalLM(LlamaConfig(**LLAMA_CFG,
                                          attn_implementation="eager"))
    hf.eval().load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    return hf


def _weights(arch: str, seed: int) -> dict:
    if arch == "gpt":
        # a wider init than GPT-2's 0.02, for varied greedy tokens
        return TG.random_gpt2_weights(GPT_CFG, seed=seed, std=0.1)
    return TL.random_llama_weights(LLAMA_CFG, seed=seed)


def _pair(arch: str, weights: dict, batch: int):
    """(JAX model, port model, wte) of the causal graph at ``batch``."""
    hf = _hf(arch, weights)
    with jax.enable_x64(False):
        jp = (JG.gpt_causal_lm if arch == "gpt" else JL.llama_causal_lm)(
            module=hf, batch_size=batch, seq_len=LEN)
        jm = nq.Model.from_onnx(jp)
    if arch == "gpt":
        tp = TG.gpt_causal_lm(weights, GPT_CFG, batch_size=batch,
                              seq_len=LEN)
    else:
        tp = TL.llama_causal_lm(weights, LLAMA_CFG, batch_size=batch,
                                seq_len=LEN)
    return jm, Model.from_onnx(tp, device="cpu"), tp._wte


def _build(arch: str) -> dict:
    weights = _weights(arch, seed=0)
    vocab = (GPT_CFG if arch == "gpt" else LLAMA_CFG)["vocab_size"]
    hidden = 64
    models = {}
    for batch in (B, B * W):
        jm, tm, wte = _pair(arch, weights, batch)
        rng = np.random.default_rng(batch)
        calib = wte[rng.integers(0, vocab, size=(batch, LEN))]
        with jax.enable_x64(False):
            stats = jm.calibration_stats([calib])
            jq = jm.quantize(stats=stats, bit_width=8)
        tq = tm.quantize(stats=stats, bit_width=8)
        models[batch] = {"float": (jm, tm), "int8": (jq, tq)}
    prompt = np.random.default_rng(9).integers(
        0, vocab, size=(B, PROMPT)).astype(np.int32)
    assert wte.shape == (vocab, hidden)
    return dict(arch=arch, weights=weights, wte=wte, vocab=vocab,
                models=models, prompt=prompt)


@pytest.fixture(scope="module")
def gpt():
    return _build("gpt")


@pytest.fixture(scope="module")
def llama():
    return _build("llama")


def _arch(request, arch):
    return request.getfixturevalue(arch)


class _JaxNoise:
    """JAX generate's per-step Gumbel draws (one key split per step),
    handed to the port's sampler in order."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape, generator):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))


@pytest.mark.parametrize("arch,dtype,option", [
    ("gpt", "float", "greedy"), ("gpt", "int8", "greedy"),
    ("llama", "float", "greedy"), ("llama", "int8", "greedy"),
    ("gpt", "float", "penalty"), ("llama", "int8", "penalty"),
    ("gpt", "float", "sampled"), ("llama", "int8", "sampled")])
def test_generate_matches_jax(request, monkeypatch, arch, dtype, option):
    m = _arch(request, arch)
    jm, tm = m["models"][B][dtype]
    kw = {"penalty": dict(repetition_penalty=1.3),
          "sampled": dict(temperature=0.9, top_k=20, top_p=0.9),
          "greedy": {}}[option]
    jkw = dict(kw)
    if option == "sampled":
        key = jax.random.PRNGKey(4)
        monkeypatch.setattr(TGEN, "_gumbel", _JaxNoise(key))
        jkw["key"] = key
    with jax.enable_x64(False):
        want = np.asarray(JGEN.generate(jm, m["prompt"], m["wte"], NEW,
                                        **jkw))
    got = TGEN.generate(tm, m["prompt"], m["wte"], NEW, **kw)
    assert got.shape == (B, PROMPT + NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,dtype,eos", [("gpt", "float", False),
                                            ("llama", "int8", False),
                                            ("gpt", "float", True)])
def test_beam_search_matches_jax(request, arch, dtype, eos):
    """Beams and scores equal JAX's, best first; with an EOS that a beam
    emits, that beam freezes (score fixed, EOS repeated), as in JAX."""
    m = _arch(request, arch)
    jm, tm = m["models"][B * W][dtype]
    eos_id = None
    if eos:
        greedy = TGEN.generate(m["models"][B][dtype][1], m["prompt"],
                               m["wte"], NEW)
        eos_id = int(greedy[0, PROMPT + 1])
    with jax.enable_x64(False):
        j_ids, j_scores = JGEN.beam_search(jm, m["prompt"], m["wte"], NEW, W,
                                           eos_id=eos_id)
    ids, scores = TGEN.beam_search(tm, m["prompt"], m["wte"], NEW, W,
                                   eos_id=eos_id)
    assert ids.shape == (B, W, PROMPT + NEW) and scores.shape == (B, W)
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_allclose(scores, np.asarray(j_scores), rtol=1e-5,
                               atol=0)
    assert (np.diff(scores, axis=1) <= 0).all()
    if eos:
        hit = ids[:, :, PROMPT:] == eos_id
        assert hit.any()
        for b, w in zip(*np.nonzero(hit.any(axis=2))):
            first = PROMPT + int(np.argmax(hit[b, w]))
            assert (ids[b, w, first:] == eos_id).all()


def test_beam_width_one_is_greedy(gpt):
    m = gpt
    tm = Model.from_onnx(TG.gpt_causal_lm(m["weights"], GPT_CFG,
                                          batch_size=B, seq_len=LEN),
                         device="cpu")
    ids, scores = TGEN.beam_search(tm, m["prompt"], m["wte"], NEW, 1)
    np.testing.assert_array_equal(
        ids[:, 0], TGEN.generate(tm, m["prompt"], m["wte"], NEW))
    assert np.isfinite(scores).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_candidate_pick_keeps_top_k_order(seed):
    """The beam's pick over [B, W*V] candidates on rows full of ties and
    signed zeros: lax.top_k's indices, lower index first among equals, +0.0
    above -0.0."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(-3, 3, size=(4, 3 * 16)).astype(np.float32)
    cand[0] = 0.0
    cand[0, rng.integers(0, 48, size=10)] = -0.0
    cand[1, :8] = np.float32(-1e30)
    cand[2] = np.float32(-1e30)
    cand[2, 40] = -0.0
    want = np.asarray(jax.lax.top_k(cand, 3)[1])
    got = TGEN._sort_descending(torch.from_numpy(cand))[:, :3].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("draft", ["perfect", "foreign", "int8_target"])
@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_speculative_matches_jax_and_greedy(request, arch, draft):
    """The speculative tokens equal target-only greedy decoding and JAX's;
    the verify rounds equal JAX's (a perfect draft: ceil(NEW / (k+1)) of
    them)."""
    m = _arch(request, arch)
    dtype = "int8" if draft == "int8_target" else "float"
    jt, tt = m["models"][B][dtype]
    if draft == "perfect":
        jd, td, wte_d = jt, tt, m["wte"]
    else:
        jd, td, wte_d = _pair(arch, _weights(arch, seed=5), B)
    k = 4
    with jax.enable_x64(False):
        j_ids, j_rounds = JGEN.generate_speculative(
            jt, jd, m["prompt"], m["wte"], wte_d, NEW, k=k)
    ids, rounds = TGEN.generate_speculative(tt, td, m["prompt"], m["wte"],
                                            wte_d, NEW, k=k)
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    assert rounds == j_rounds
    np.testing.assert_array_equal(
        ids, TGEN.generate(tt, m["prompt"], m["wte"], NEW))
    if draft == "perfect":
        assert rounds == -(-NEW // (k + 1))
    else:
        assert 1 <= rounds <= NEW


@pytest.mark.parametrize("case", ["generate_length", "beam_length",
                                  "beam_batch", "speculative_length",
                                  "key"])
def test_length_batch_and_key_checks(gpt, case):
    """JAX's length and batch checks, and the refused PRNG key."""
    m = gpt
    _, tm = m["models"][B]["float"]
    _, tbeam = m["models"][B * W]["float"]
    p, wte = m["prompt"], m["wte"]
    if case == "key":
        with pytest.raises(NotImplementedError, match="generator="):
            TGEN.generate(tm, p, wte, NEW, temperature=0.5, key=object())
        return
    with pytest.raises(ValueError):
        if case == "generate_length":
            TGEN.generate(tm, p, wte, LEN - PROMPT + 1)
        elif case == "beam_length":
            TGEN.beam_search(tbeam, p, wte, LEN - PROMPT + 1, W)
        elif case == "beam_batch":
            TGEN.beam_search(tm, p, wte, NEW, W)
        else:
            TGEN.generate_speculative(tm, tm, p, wte, wte,
                                      LEN - PROMPT - 2, k=4)
