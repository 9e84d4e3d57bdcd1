"""The port's continuous-batching engine (``utils/serving.py::
ContinuousBatcher``) held against the JAX package's, token for token, on
tiny GPT-2 (2 layers, n_embd 64, 4 heads, vocab 96) and LLaMA (2 layers,
hidden 64, 4 heads, 2 KV heads, vocab 128) step graphs with 3 slots and a
16-slot cache, float and int8, in TPU-mode numerics (x64 off). JAX builds
its graphs from ``transformers`` modules loaded with the port's random
weights; the port builds its own from the same numpy weights. The int8
models of both packages quantize with one set of stats (JAX's
``decode_calibration``).

Every form runs one ragged workload (more requests than slots, prompts of
1-6 tokens, budgets 3-8): dense; int8 unfused and ``optimize()``d
(DecodeAttention) with float and int8 caches; paged with a pool small
enough to preempt; ``steps_per_sync=4``; ``prefill_model`` (gpt_prefill,
llama_prefill) with a prompt longer than the prefill length and a request
that finishes at admission. Tolerance: zero. The tokens equal JAX's
engine's, ``stats`` equal JAX's (steps, slot steps, prefills, completions,
generated tokens, preemptions), and the greedy teacher-forced forms equal
the port's solo ``generate_kv`` of each request on a batch-1 step graph.
The ``optimize()``d int8 step's DecodeAttention runs float dots; on the CPU
its context product sums in XLA's order, so its int8 output equals JAX's
and no request parts from JAX's tokens (``FUSED_FLIPS`` is empty: the tiny
LLaMA's request 4 once parted at output position 7, where the context's
int8 quantize rounded a one-ulp difference across a step). Sampling: the port's noise function is patched to hand out JAX's
``gumbel(fold_in(key, step), (B, V))``, so sampled tokens are compared
exactly too.
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
from numpy_quant_tpu.utils import merge_calibration_stats as j_merge
from numpy_quant_tpu.utils.serving import ContinuousBatcher as JBatcher
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.models import gpt as TG
from numpy_quant_tpu_torch.models import llama as TL
from numpy_quant_tpu_torch.utils import ContinuousBatcher, generate_kv
from numpy_quant_tpu_torch.utils import serving as TS

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

SLOTS, MAX_LEN, PREFILL = 3, 16, 6
GPT_CFG = dict(vocab_size=96, n_positions=MAX_LEN, n_embd=64, n_layer=2,
               n_head=4)
LLAMA_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=1024,
                 rms_norm_eps=1e-5, rope_theta=10000.0,
                 initializer_range=0.02, tie_word_embeddings=False)
# (prompt length, new tokens): more requests than slots, ragged
SHAPES = [(1, 6), (3, 4), (2, 8), (5, 3), (4, 5), (6, 7), (2, 3)]
LONG = [(9, 4)]  # longer than PREFILL: teacher forced under prefill_model


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _build(arch: str) -> dict:
    """Both packages' step graphs (3 slots and 1), prefill graphs and int8
    models of ``arch``, on one set of weights and one set of stats."""
    if arch == "gpt":
        # a wider init than GPT-2's 0.02, for varied greedy tokens
        weights = TG.random_gpt2_weights(GPT_CFG, seed=0, std=0.1)
        hf = GPT2LMHeadModel(GPT2Config(**GPT_CFG, activation_function="gelu",
                                        attn_implementation="eager")).eval()
        cfg, vocab = GPT_CFG, GPT_CFG["vocab_size"]
        j_step = lambda b: JG.gpt_decode_step(module=hf, batch_size=b,
                                              max_len=MAX_LEN)
        t_step = lambda b: TG.gpt_decode_step(weights, cfg, batch_size=b,
                                              max_len=MAX_LEN)
        t_pf = TG.gpt_prefill(weights, cfg, PREFILL)
    else:
        weights = TL.random_llama_weights(LLAMA_CFG, seed=0)
        hf = LlamaForCausalLM(LlamaConfig(**LLAMA_CFG,
                                          attn_implementation="eager"))
        hf.eval()
        cfg, vocab = LLAMA_CFG, LLAMA_CFG["vocab_size"]
        j_step = lambda b: JL.llama_decode_step(batch_size=b,
                                                max_len=MAX_LEN, module=hf)
        t_step = lambda b: TL.llama_decode_step(weights, cfg, batch_size=b,
                                                max_len=MAX_LEN)
        t_pf = TL.llama_prefill(weights, cfg, PREFILL)
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    with jax.enable_x64(False):
        jp = j_step(SLOTS)
        jm = nq.Model.from_onnx(jp)
        j_pf = nq.Model.from_onnx(
            JG.gpt_prefill(prefill_len=PREFILL, module=hf) if arch == "gpt"
            else JL.llama_prefill(prefill_len=PREFILL, module=hf))
        rope = getattr(jp, "_rope_tables", None)
        wpe = getattr(jp, "_wpe", None)
        prompt = np.random.default_rng(5).integers(
            0, vocab, size=(SLOTS, 6)).astype(np.int32)
        stats = j_merge(*[jm.calibration_stats(b) for b in
                          JGEN.decode_calibration(jm, prompt, jp._wte, wpe,
                                                  rope=rope)])
        jq = jm.quantize(stats=stats, bit_width=8)
        jqf = jm.quantize(stats=stats, bit_width=8)
        jqf.optimize()
    tp = t_step(SLOTS)
    tm = Model.from_onnx(tp, device="cpu")
    tq = tm.quantize(stats=stats, bit_width=8)
    tqf = tm.quantize(stats=stats, bit_width=8)
    tqf.optimize()
    solo = Model.from_onnx(t_step(1), device="cpu")
    solo_fused = solo.quantize(stats=stats, bit_width=8)
    solo_fused.optimize()
    return dict(
        arch=arch, vocab=vocab, rope=rope, jwte=jp._wte, jwpe=wpe,
        twte=tp._wte, twpe=getattr(tp, "_wpe", None),
        trope=getattr(tp, "_rope_tables", None),
        j={"float": jm, "int8": jq, "int8_fused": jqf, "prefill": j_pf},
        t={"float": tm, "int8": tq, "int8_fused": tqf,
           "prefill": Model.from_onnx(t_pf, device="cpu")},
        solo={"float": solo, "int8": solo.quantize(stats=stats, bit_width=8),
              "int8_fused": solo_fused})


@pytest.fixture(scope="module")
def gpt():
    return _build("gpt")


@pytest.fixture(scope="module")
def llama():
    return _build("llama")


def _arch(request, arch):
    return request.getfixturevalue(arch)


def _requests(vocab: int, seed: int, shapes=SHAPES) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=(k,)).astype(np.int32), n)
            for k, n in shapes]


def _engines(m: dict, model: str, prefill: bool = False, **kw):
    """(JAX engine, port engine) over ``m``'s ``model`` step."""
    j = JBatcher(m["j"][model], m["jwte"], m["jwpe"], rope=m["rope"],
                 prefill_model=m["j"]["prefill"] if prefill else None, **kw)
    t = ContinuousBatcher(m["t"][model], m["twte"], m["twpe"],
                          rope=m["trope"],
                          prefill_model=m["t"]["prefill"] if prefill
                          else None, **kw)
    return j, t


def _same(j_out: dict, t_out: dict, j_stats: dict, t_stats: dict) -> None:
    assert sorted(t_out) == sorted(j_out)
    for rid in j_out:
        np.testing.assert_array_equal(t_out[rid], np.asarray(j_out[rid]),
                                      err_msg=f"request {rid}")
        assert t_out[rid].dtype == np.int32
    assert {k: int(v) for k, v in t_stats.items()} \
        == {k: int(v) for k, v in j_stats.items()}


def _solo(m: dict, model: str, reqs: list, out: dict, cache=None) -> None:
    """Each request's tokens equal its own generate_kv on the batch-1
    step graph."""
    for rid, (prompt, n) in enumerate(reqs):
        want = generate_kv(m["solo"][model], prompt[None, :], m["twte"],
                           m["twpe"], n, rope=m["trope"],
                           kv_cache_dtype=cache)[0]
        np.testing.assert_array_equal(out[rid], want, err_msg=f"req {rid}")


# (step model, engine arguments), split between the two architectures
FORMS = {
    "dense_float": ("float", {}),
    "dense_int8": ("int8", {}),
    "dense_int8_fused_int8_cache": ("int8_fused", dict(kv_cache_dtype="int8")),
    "paged_float_preempt": ("float", dict(paged_kv=(2, 9))),
    "paged_int8_fused_int8_cache_preempt": (
        "int8_fused", dict(paged_kv=(2, 9), kv_cache_dtype="int8")),
    "k4_dense_int8_cache": ("int8", dict(steps_per_sync=4,
                                         kv_cache_dtype="int8")),
    "k4_paged_float": ("float", dict(steps_per_sync=4, paged_kv=(3, 7))),
}
# {(arch, form): {request: output position}}: where the fused int8 step's
# tokens part from JAX's on the seed-11 workload (see the docstring): none
FUSED_FLIPS = {}
CASES = [("gpt", "dense_float"), ("gpt", "dense_int8"),
         ("gpt", "paged_int8_fused_int8_cache_preempt"),
         ("gpt", "k4_dense_int8_cache"), ("llama", "dense_float"),
         ("llama", "dense_int8_fused_int8_cache"),
         ("llama", "paged_float_preempt"), ("llama", "k4_paged_float")]


@pytest.mark.parametrize("arch,form", CASES)
def test_engine_matches_jax_and_solo(request, arch, form):
    m = _arch(request, arch)
    model, kw = FORMS[form]
    reqs = _requests(m["vocab"], seed=11)
    with jax.enable_x64(False):
        j, t = _engines(m, model, **kw)
        j_out = j.run(list(reqs))
    t_out = t.run(list(reqs))
    for rid, at in FUSED_FLIPS.get((arch, form), {}).items():
        # JAX's tokens up to the flip; the rest is held to the port's own
        # solo fused decode below
        np.testing.assert_array_equal(t_out[rid][:at],
                                      np.asarray(j_out[rid])[:at])
        j_out[rid] = t_out[rid]
    _same(j_out, t_out, j.stats, t.stats)
    if "paged" in form and "preempt" in form:
        assert t.stats["preemptions"] >= 1
    if "paged" in form:
        # every block back on the free list, in JAX's order
        assert t._free == j._free and not any(t._owned)
    _solo(m, model, reqs, t_out, kw.get("kv_cache_dtype"))


@pytest.mark.parametrize("arch,paged", [("gpt", None), ("llama", (2, 12))],
                         ids=["gpt-dense", "llama-paged"])
def test_prefill_admission_matches_jax(request, arch, paged):
    """Prefill admission (float step, float prefill graph): a prompt longer
    than the prefill length is teacher forced, a one-token budget finishes
    at admission and never takes a slot; the tokens also equal the solo
    teacher-forced decode."""
    m = _arch(request, arch)
    reqs = _requests(m["vocab"], seed=12) + [
        (np.arange(3, dtype=np.int32), 1)] + _requests(m["vocab"], 13, LONG)
    kw = {} if paged is None else dict(paged_kv=paged)
    with jax.enable_x64(False):
        j, t = _engines(m, "float", prefill=True, **kw)
        j_out = j.run(list(reqs))
    t_out = t.run(list(reqs))
    _same(j_out, t_out, j.stats, t.stats)
    assert t.stats["prefills"] == len(reqs) - 1
    _solo(m, "float", reqs, t_out)


def test_prefill_int8_cache_writes_quantized_presents(llama):
    """int8 prefill admission into an int8 cache equals JAX's, and the
    admitted slot's cache rows [0, plen) hold the quantized presents."""
    m = llama
    reqs = _requests(m["vocab"], seed=14, shapes=[(5, 4), (2, 6), (6, 3)])
    with jax.enable_x64(False):
        j, t = _engines(m, "int8_fused", prefill=True,
                        kv_cache_dtype="int8")
        j_out = j.run(list(reqs))
    t_out = t.run(list(reqs))
    _same(j_out, t_out, j.stats, t.stats)
    prompt = reqs[0][0]
    emb = np.zeros((1, PREFILL, m["twte"].shape[1]), np.float32)
    emb[0, :len(prompt)] = m["twte"][prompt]
    outs = m["t"]["prefill"]([emb], as_numpy=False)
    assert int(torch.argmax(outs[0][0, len(prompt) - 1])) == t_out[0][5]
    for cache, present, q in zip(t._caches, outs[1:], t._q_cache):
        assert cache.dtype == torch.int8
        torch.testing.assert_close(cache[0, :, :len(prompt)],
                                   q(present)[0, :, :len(prompt)],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_eos_retires_early(request, arch):
    m = _arch(request, arch)
    reqs = _requests(m["vocab"], seed=15)
    dense = ContinuousBatcher(m["t"]["float"], m["twte"], m["twpe"],
                              rope=m["trope"]).run(list(reqs))
    eos = int(dense[2][len(reqs[2][0]) + 1])  # request 2's second token
    with jax.enable_x64(False):
        j, t = _engines(m, "float", eos_id=eos)
        j_out = j.run(list(reqs))
    t_out = t.run(list(reqs))
    _same(j_out, t_out, j.stats, t.stats)
    got = t_out[2]
    assert got[-1] == eos and len(got) <= len(dense[2])
    assert t.stats["tokens_out"] < sum(n for _, n in reqs)


def _jax_noise(seed, stream, shape, device):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), stream)
    return torch.from_numpy(np.array(jax.random.gumbel(key, shape)))


@pytest.mark.parametrize("arch,form", [("gpt", "k1"), ("llama", "k4"),
                                       ("gpt", "prefill")])
def test_sampling_matches_jax_noise(request, monkeypatch, arch, form):
    """Per-slot temperature: every other request sampled at 0.8, the rest
    greedy, with JAX's noise; k=4 also equals k=1 where the requests are
    admitted together (the noise is that of the absolute step)."""
    m = _arch(request, arch)
    monkeypatch.setattr(TS, "_slot_noise", _jax_noise)
    reqs = [r + (None, 0.8 if i % 2 == 0 else None)
            for i, r in enumerate(_requests(m["vocab"], seed=16))]
    kw = dict(steps_per_sync=4) if form == "k4" else {}
    prefill = form == "prefill"
    with jax.enable_x64(False):
        j = JBatcher(m["j"]["float"], m["jwte"], m["jwpe"], rope=m["rope"],
                     key=jax.random.PRNGKey(7),
                     prefill_model=m["j"]["prefill"] if prefill else None,
                     **kw)
        j_out = j.run(list(reqs))
    t = ContinuousBatcher(m["t"]["float"], m["twte"], m["twpe"],
                          rope=m["trope"], seed=7,
                          prefill_model=m["t"]["prefill"] if prefill
                          else None, **kw)
    t_out = t.run(list(reqs))
    _same(j_out, t_out, j.stats, t.stats)
    if form == "k4":
        first = reqs[:SLOTS]  # admitted together: one schedule for any k
        runs = [ContinuousBatcher(m["t"]["float"], m["twte"], m["twpe"],
                                  rope=m["trope"], seed=7,
                                  steps_per_sync=k).run(list(first))
                for k in (1, 4)]
        for rid in runs[0]:
            np.testing.assert_array_equal(runs[1][rid], runs[0][rid])


def test_sampling_noise_is_seeded_per_step():
    """The port's own noise: a function of (seed, step) alone."""
    a = TS._slot_noise(3, 10, (2, 5), torch.device("cpu"))
    np.testing.assert_array_equal(
        a, TS._slot_noise(3, 10, (2, 5), torch.device("cpu")))
    assert not torch.equal(a, TS._slot_noise(3, 11, (2, 5),
                                             torch.device("cpu")))
    assert not torch.equal(a, TS._slot_noise(4, 10, (2, 5),
                                             torch.device("cpu")))


def test_step_reset_and_stats_match_jax(llama):
    """step() by hand: finished requests report as they finish, a request
    admitted into a freed slot mid-flight, n_active/n_queued, then reset()
    mid-flight and a fresh workload; stats equal JAX's throughout."""
    m = llama
    reqs = _requests(m["vocab"], seed=17)
    with jax.enable_x64(False):
        j, t = _engines(m, "float")
        for e in (j, t):
            for r in reqs[:4]:
                e.submit(*r)
        for _ in range(3):
            j_done, t_done = j.step(), t.step()
            assert [r for r, _ in t_done] == [r for r, _ in j_done]
            assert (t.n_active, t.n_queued) == (j.n_active, j.n_queued)
        assert t.stats == {k: int(v) for k, v in j.stats.items()}
        j.reset()
        t.reset()
        assert (t.n_active, t.n_queued) == (0, 0)
        assert all(v == 0 for v in t.stats.values())
        j_out, t_out = j.run(reqs[3:]), t.run(reqs[3:])
    _same(j_out, t_out, j.stats, t.stats)


@pytest.mark.parametrize("arg", ["key", "state_carry", "has_memory",
                                 "score_bias"])
def test_unported_arguments_raise(gpt, arg):
    """A JAX key is refused; the Mamba layout takes no wpe (JAX's
    ValueError); the T5 and seq2seq layouts need a step graph with their
    inputs (GPT-2's has none)."""
    value = {"key": 0, "state_carry": True, "has_memory": True,
             "score_bias": np.zeros((MAX_LEN, 4, MAX_LEN + 1),
                                    np.float32)}[arg]
    error, match = {"key": (NotImplementedError, "seed="),
                    "state_carry": (ValueError, "state_carry engines")}.get(
        arg, (ValueError, "layout"))
    with pytest.raises(error, match=match):
        ContinuousBatcher(gpt["t"]["float"], gpt["twte"], gpt["twpe"],
                          **{arg: value})


@pytest.mark.parametrize("case", ["int8_cache_on_float_model",
                                  "cache_dtype", "paged_pool",
                                  "prefill_batch", "long_request",
                                  "empty_prompt", "no_budget",
                                  "pool_too_small", "memory_row"])
def test_invalid_engine_arguments_raise(gpt, case):
    """JAX's ValueErrors, case for case."""
    m = gpt

    def make(**kw):
        return ContinuousBatcher(m["t"]["float"], m["twte"], m["twpe"], **kw)

    with pytest.raises(ValueError):
        if case == "int8_cache_on_float_model":
            make(kv_cache_dtype="int8")
        elif case == "cache_dtype":
            ContinuousBatcher(m["t"]["int8"], m["twte"], m["twpe"],
                              kv_cache_dtype="fp8")
        elif case == "paged_pool":
            make(paged_kv=(4, 1))
        elif case == "prefill_batch":
            make(prefill_model=m["t"]["float"])
        elif case == "long_request":
            make().submit(np.zeros(10, np.int32), MAX_LEN)
        elif case == "empty_prompt":
            make().submit(np.zeros(0, np.int32), 2)
        elif case == "no_budget":
            make().submit(np.zeros(2, np.int32), 0)
        elif case == "pool_too_small":
            make(paged_kv=(2, 3)).submit(np.zeros(3, np.int32), 4)
        else:
            make().submit(np.zeros(2, np.int32), 2,
                          np.zeros((4, 64), np.float32))
