"""The continuous-batching engine's score-bias and encoder-memory layouts
(``ContinuousBatcher(score_bias=, has_memory=True)``) on the port's T5
decode step, held against the JAX package's engine and the port's own
lockstep ``generate_kv``, on JAX's tiny T5 (d_model 32, 4 heads, 2 + 2
layers, vocabulary 96) with 2 slots, an 8-slot cache and a 6-token source,
in TPU-mode numerics (x64 off). Every request brings its own encoder
memory (the module's encoder output over its own source).

Tolerance: zero. The engine's tokens equal JAX's engine's and each
request's batch-1 ``generate_kv`` with its own memory, float and int8 with
an int8 cache; the engine feeds per-row ``[B, H, 1, L+1]`` bias rows where
``generate_kv`` feeds ``[1, H, 1, L+1]``, and the fused DecodeAttention
broadcasts both as the unfused Add does (each row of a per-row forward
equals that row under its own bias row alone, bit for bit; the fused float
step lies within 1e-5 * max|output| of the unfused one, whose context
product sums in torch's order where the fused one follows XLA's on the
CPU). A ``memory_row`` given
to an engine without memory, one missing where memory is needed, and a
``prefill_model`` with either layout raise ValueError, as in JAX.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from transformers import T5ForConditionalGeneration

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import t5 as JT
from numpy_quant_tpu.utils.serving import ContinuousBatcher as JBatcher
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.models import t5 as TT
from numpy_quant_tpu_torch.passes.decode_attention import \
    fuse_decode_attention
from numpy_quant_tpu_torch.utils import (ContinuousBatcher,
                                         decode_calibration, generate_kv,
                                         merge_calibration_stats)

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

SLOTS, L, S = 2, 8, 6
# (prompt length after the start token, new tokens): more than the slots
SHAPES = [(0, 5), (2, 4), (1, 6), (0, 3)]


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def t5s():
    torch.manual_seed(0)
    hf = T5ForConditionalGeneration(JT.default_config(max(S, L))).eval()
    w = {k: v.detach().numpy().copy() for k, v in hf.state_dict().items()}
    cfg = {k: getattr(hf.config, k) for k in TT.T5_SMALL}
    tp = TT.t5_decode_step(w, cfg, batch_size=SLOTS, max_len=L, src_len=S)
    solo = TT.t5_decode_step(w, cfg, batch_size=1, max_len=L, src_len=S)
    rng = np.random.default_rng(11)
    start = int(hf.config.pad_token_id)
    reqs = []
    for extra, new in SHAPES:
        src = rng.integers(4, 96, size=(1, S))
        with torch.no_grad():
            mem = hf.encoder(inputs_embeds=torch.from_numpy(
                tp._wte[src])).last_hidden_state.numpy()[0]
        prompt = np.concatenate([[start], rng.integers(4, 96, size=extra)])
        reqs.append((prompt.astype(np.int32), new, mem))
    tm = Model.from_onnx(tp, device="cpu")
    calib = np.stack([r[2] for r in reqs[:SLOTS]])
    qprompt = np.concatenate([np.full((SLOTS, 1), start), rng.integers(
        4, 96, size=(SLOTS, 2))], axis=1).astype(np.int32)
    stats = merge_calibration_stats(*[tm.calibration_stats(b) for b in
                                      decode_calibration(
                                          tm, qprompt, tp._wte, None,
                                          score_bias=tp._decode_bias,
                                          memory=calib)])
    with jax.enable_x64(False):
        jp = JT.t5_decode_step(batch_size=SLOTS, max_len=L, src_len=S,
                               module=hf)
        jm = nq.Model.from_onnx(jp)
        j_out = {"float": JBatcher(jm, jp._wte, None,
                                   score_bias=jp._decode_bias,
                                   has_memory=True).run(reqs)}
        jq = jm.quantize(stats=stats, bit_width=8)
        j_out["int8"] = JBatcher(jq, jp._wte, None,
                                 score_bias=jp._decode_bias, has_memory=True,
                                 kv_cache_dtype="int8").run(reqs)
    return dict(tp=tp, solo=solo, tm=tm, reqs=reqs, stats=stats, j_out=j_out)


def _engine(model, t5s, **kw):
    return ContinuousBatcher(model, t5s["tp"]._wte, None,
                             score_bias=t5s["tp"]._decode_bias,
                             has_memory=True, **kw)


def _solo(model, t5s, req, **kw):
    prompt, new, mem = req
    return generate_kv(model, prompt[None, :], t5s["solo"]._wte, None, new,
                       score_bias=t5s["solo"]._decode_bias,
                       memory=mem[None], **kw)[0]


@pytest.mark.parametrize("form", ["float", "int8"])
def test_bias_memory_engine_matches_jax_and_solo(t5s, form):
    """Per-row bias rows and per-slot memory rows: the engine's tokens
    equal JAX's engine's and each request's lockstep generate_kv."""
    model, solo, kw = t5s["tm"], Model.from_onnx(t5s["solo"], device="cpu"), {}
    if form == "int8":
        model = model.quantize(stats=t5s["stats"], bit_width=8)
        solo = solo.quantize(stats=t5s["stats"], bit_width=8)
        kw = dict(kv_cache_dtype="int8")
    engine = _engine(model, t5s, **kw)
    got = engine.run(t5s["reqs"])
    assert engine.stats["completed"] == len(t5s["reqs"])
    for rid, req in enumerate(t5s["reqs"]):
        np.testing.assert_array_equal(got[rid], t5s["j_out"][form][rid],
                                      err_msg=f"req {rid}")
        np.testing.assert_array_equal(got[rid], _solo(solo, t5s, req, **kw),
                                      err_msg=f"req {rid}")


def test_decode_attention_takes_per_row_bias_rows(t5s):
    """A float step fused by fuse_decode_attention (DecodeAttention, the bias
    as an extra input) broadcasts the engine's per-row [B, H, 1, L+1] bias
    rows as generate_kv's [1, H, 1, L+1] row: each row of a per-row forward
    equals, bit for bit, that row of a forward under its own row alone; the
    fused step lies within 1e-5 * max|output| of the unfused one (on the CPU
    its context product sums in XLA's order, torch's unfused MatMul in its
    own), and the fused engine decodes the unfused engine's tokens."""
    tp, reqs = t5s["tp"], t5s["reqs"]
    fused = Model.from_onnx(tp, device="cpu")
    assert fuse_decode_attention(fused) == 2
    rng = np.random.default_rng(3)
    table = tp._decode_bias
    base = [rng.normal(size=tuple(v.shape_hint)).astype(np.float32)
            for v in t5s["tm"].inputs]
    base[1] = np.zeros_like(base[1])
    rows = (3, 5)
    per_row = fused(base[:2] + [table[list(rows)][:, :, None, :]] + base[3:])
    want = t5s["tm"](base[:2] + [table[list(rows)][:, :, None, :]]
                     + base[3:])
    for g, w in zip(per_row, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    for b, t in enumerate(rows):
        alone = fused(base[:2] + [table[t][None, :, None, :]] + base[3:])
        for g, a in zip(per_row, alone):
            np.testing.assert_array_equal(g[b], a[b])
    np.testing.assert_array_equal(
        np.concatenate(list(_engine(fused, t5s).run(reqs).values())),
        np.concatenate(list(_engine(t5s["tm"], t5s).run(reqs).values())))


@pytest.mark.parametrize("case", ["memory_row_without_memory",
                                  "memory_row_missing", "prefill_with_bias",
                                  "prefill_with_memory"])
def test_layout_refusals(t5s, case):
    from numpy_quant_tpu_torch.models import gpt as TG
    prompt, new, mem = t5s["reqs"][0]
    with pytest.raises(ValueError):
        if case == "memory_row_missing":
            _engine(t5s["tm"], t5s).submit(prompt, new)
        elif case == "memory_row_without_memory":
            gcfg = dict(vocab_size=96, n_positions=L, n_embd=32, n_layer=1,
                        n_head=4)
            gw = TG.random_gpt2_weights(gcfg, seed=0)
            gstep = Model.from_onnx(TG.gpt_decode_step(gw, gcfg, 2, L),
                                    device="cpu")
            ContinuousBatcher(gstep, gw["transformer.wte.weight"],
                              gw["transformer.wpe.weight"]).submit(
                prompt, new, mem)
        else:
            gcfg = dict(vocab_size=96, n_positions=L, n_embd=32, n_layer=1,
                        n_head=4)
            prefill = Model.from_onnx(TG.gpt_prefill(
                TG.random_gpt2_weights(gcfg, seed=0), gcfg, 4), device="cpu")
            if case == "prefill_with_bias":
                ContinuousBatcher(t5s["tm"], t5s["tp"]._wte, None,
                                  score_bias=t5s["tp"]._decode_bias,
                                  has_memory=True, prefill_model=prefill)
            else:
                _engine(t5s["tm"], t5s, prefill_model=prefill)
