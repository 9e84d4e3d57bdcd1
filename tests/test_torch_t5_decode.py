"""The port's T5 KV-cache decode step (``models/t5.py::t5_decode_step``)
and the score-bias and memory forms of ``generate_kv`` and
``decode_calibration``, held against the live ``transformers`` module and
the JAX package on JAX's tiny config (d_model 32, 4 heads, d_kv 8, d_ff 48,
2 + 2 layers, 8 buckets, vocab 96; B=2, cache 8, source 12), in TPU-mode
numerics (x64 off). JAX builds its graphs from the module; the port builds
its own from the module's ``state_dict()`` as numpy. Both decode against
one encoder memory, the module's own encoder output.

Tolerances: the step graph equals JAX's node for node with equal
initializers, and the ``[L, H, L+1]`` decode-bias table equals JAX's bit
for bit. Greedy float tokens equal JAX's ``generate_kv`` and the module's
full re-forward loop (JAX's oracle, tests/test_t5.py). The
``decode_calibration`` batches equal JAX's in every input but the caches,
which lie within 1e-5 * max|cache| (f32 sums in another order). With JAX's
quantized state installed (``load_jax_params``), every integer
intermediate of one int8 step equals JAX's (0 differ), int8 tokens equal
JAX's int8 tokens, the int8 KV cache's tokens equal the float-carry ones, and
after ``optimize()`` the fused nodes (two DecodeAttention chains with the
bias as their second extra input, the cross-attention as JAX fuses it) and
their inputs equal JAX's, the fusion report equals JAX's but for the
failures fuse_attention recorded on the Softmaxes DecodeAttention then
fused (the port's decode fusion drops them), and the fused tokens equal
JAX's fused tokens.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from transformers import T5ForConditionalGeneration

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import t5 as JT
from numpy_quant_tpu.utils import merge_calibration_stats as j_merge
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.models import t5 as TT
from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                         merge_calibration_stats)
from .torch_parity import (assert_integers_equal, assert_same_graph,
                           greedy_hf, jax_qvalues, jax_state)

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

B, L, S, NEW = 2, 8, 12, 6


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def t5d():
    torch.manual_seed(0)
    hf = T5ForConditionalGeneration(JT.default_config(max(S, L))).eval()
    w = {k: v.detach().numpy().copy() for k, v in hf.state_dict().items()}
    cfg = {k: getattr(hf.config, k) for k in TT.T5_SMALL}
    rng = np.random.default_rng(7)
    start = int(hf.config.pad_token_id)  # T5's decoder start is the pad
    with jax.enable_x64(False):
        jp = JT.t5_decode_step(batch_size=B, max_len=L, src_len=S, module=hf)
        jm = nq.Model.from_onnx(jp)
        src = rng.integers(4, 96, size=(B, S))
        with torch.no_grad():
            memory = hf.encoder(inputs_embeds=torch.from_numpy(
                jp._wte[src])).last_hidden_state.numpy()
        prompt = np.full((B, 1), start, np.int32)
        j_float = JGEN.generate_kv(jm, prompt, jp._wte, None, NEW,
                                   score_bias=jp._decode_bias, memory=memory)
        qprompt = np.concatenate(
            [prompt, rng.integers(4, 96, size=(B, 2)).astype(np.int32)], 1)
        j_batches = JGEN.decode_calibration(jm, qprompt, jp._wte, None,
                                            score_bias=jp._decode_bias,
                                            memory=memory)
        stats = j_merge(*[jm.calibration_stats(b) for b in j_batches])
        jq = jm.quantize(stats=stats, bit_width=8)
        j_int8 = JGEN.generate_kv(jq, qprompt, jp._wte, None, 4,
                                  score_bias=jp._decode_bias, memory=memory)
        state = jax_state(jq)
        jq.optimize()
        j_fused = JGEN.generate_kv(jq, qprompt, jp._wte, None, 4,
                                   score_bias=jp._decode_bias, memory=memory)
        j_report = {k: v for k, v in jq.fusion_report.items()}
        j_nodes = [(n.op, [v.name for v in n.inputs]) for n in jq.nodes
                   if n.op in ("DecodeAttention", "FusedAttentionHS",
                               "FusedAttention")]
    tp = TT.t5_decode_step(w, cfg, batch_size=B, max_len=L, src_len=S)
    return dict(hf=hf, w=w, cfg=cfg, jp=jp, tp=tp, memory=memory,
                start=start, prompt=prompt, qprompt=qprompt,
                j_float=j_float, j_batches=j_batches, stats=stats,
                state=state, j_int8=j_int8, j_fused=j_fused,
                j_report=j_report, j_nodes=j_nodes,
                src_embeds=jp._wte[src])


def _port_int8(t5d):
    tq = Model.from_onnx(t5d["tp"], device="cpu").quantize(
        stats=t5d["stats"], bit_width=8)
    load_jax_params(tq, t5d["state"])
    return tq


def _gen(model, t5d, prompt, new, **kw):
    return generate_kv(model, prompt, t5d["tp"]._wte, None, new,
                       score_bias=t5d["tp"]._decode_bias,
                       memory=t5d["memory"], **kw)


def test_step_graph_and_bias_table_equal_jax(t5d):
    assert_same_graph(t5d["tp"], t5d["jp"])
    np.testing.assert_array_equal(t5d["tp"]._wte, t5d["jp"]._wte)
    table = t5d["tp"]._decode_bias
    assert table.dtype == np.float32 and table.shape == (L, 4, L + 1)
    np.testing.assert_array_equal(table, t5d["jp"]._decode_bias)


def test_float_greedy_matches_jax_and_module(t5d):
    """The step graph decodes the module's full re-forward greedy tokens
    and JAX's generate_kv tokens; the relative bias enters per step."""
    got = _gen(Model.from_onnx(t5d["tp"], device="cpu"), t5d, t5d["prompt"],
               NEW)
    want = greedy_hf(t5d["hf"], t5d["start"], NEW,
                     inputs_embeds=t5d["src_embeds"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t5d["j_float"])


def test_decode_calibration_matches_jax(t5d):
    tm = Model.from_onnx(t5d["tp"], device="cpu")
    batches = decode_calibration(tm, t5d["qprompt"], t5d["tp"]._wte, None,
                                 score_bias=t5d["tp"]._decode_bias,
                                 memory=t5d["memory"])
    assert len(batches) == len(t5d["j_batches"]) == t5d["qprompt"].shape[1]
    names = [v.name for v in tm.inputs]
    for got, want in zip(batches, t5d["j_batches"]):
        assert len(got) == len(want) == len(names)
        for name, g, w in zip(names, got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape, name
            if name.startswith("past_"):
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-30),
                    err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
    stats = merge_calibration_stats(*[tm.calibration_stats(b)
                                      for b in batches])
    assert set(stats) == set(t5d["stats"])


def test_int8_step_intermediates_match_jax(t5d):
    """One int8 step (the last calibration step's inputs, with JAX's
    quantized state): every integer intermediate equals JAX's."""
    tq = _port_int8(t5d)
    inputs = [np.array(a) for a in t5d["j_batches"][-1]]
    tq(inputs, record=True)
    with jax.enable_x64(False):
        jq = nq.Model.from_onnx(t5d["jp"]).quantize(stats=t5d["stats"],
                                                    bit_width=8)
        want = jax_qvalues(jq, inputs)
    assert assert_integers_equal(tq, want) >= 50


@pytest.mark.parametrize("cache", [None, "int8"], ids=["float_cache",
                                                       "int8_cache"])
def test_int8_tokens_match_jax(t5d, cache):
    """With JAX's quantized state the port's int8 step decodes JAX's
    tokens; the int8 cache stores each present quantized with its cache
    input's params, so its tokens equal the float carry's."""
    got = _gen(_port_int8(t5d), t5d, t5d["qprompt"], 4, kv_cache_dtype=cache)
    np.testing.assert_array_equal(got[:, :3], t5d["qprompt"])
    np.testing.assert_array_equal(got, t5d["j_int8"])


def test_fused_step_matches_jax(t5d):
    """optimize() fuses what JAX fuses, with the same inputs (the mask and
    the score bias ride as DecodeAttention's extra inputs), and the fused
    int8 step decodes JAX's fused tokens, with a float and an int8 cache."""
    tq = _port_int8(t5d)
    tq.optimize()
    assert tq.fusion_report["fused"] == t5d["j_report"]["fused"]
    fused_sm = {f"Softmax{n.outputs[0].name.rsplit('/', 1)[0]}/probs"
                for n in tq.nodes if n.op == "DecodeAttention"}
    # the Softmaxes DecodeAttention fused leave the port's failures list;
    # JAX's keeps fuse_attention's entries for them
    assert tq.fusion_report["failures"] == [
        f for f in t5d["j_report"]["failures"] if f[0] not in fused_sm]
    assert {f[0] for f in t5d["j_report"]["failures"]} == fused_sm
    nodes = [(n.op, [v.name for v in n.inputs]) for n in tq.nodes
             if n.op in ("DecodeAttention", "FusedAttentionHS",
                         "FusedAttention")]
    assert nodes == t5d["j_nodes"]
    dec = [n for n in nodes if n[0] == "DecodeAttention"]
    assert len(dec) == 2 and all(sorted(n[1][5:]) == ["attn_mask",
                                                      "score_bias"]
                                 for n in dec)
    for cache in (None, "int8"):
        got = _gen(tq, t5d, t5d["qprompt"], 4, kv_cache_dtype=cache)
        np.testing.assert_array_equal(got, t5d["j_fused"])


def test_layout_arguments_must_match_the_graph(t5d):
    """generate_kv refuses arguments that do not give the step graph's
    input layout."""
    tm = Model.from_onnx(t5d["tp"], device="cpu")
    with pytest.raises(ValueError, match="layout"):
        generate_kv(tm, t5d["prompt"], t5d["tp"]._wte, None, 2,
                    memory=t5d["memory"])
    with pytest.raises(ValueError, match="layout"):
        decode_calibration(tm, t5d["prompt"], t5d["tp"]._wte, None,
                           score_bias=t5d["tp"]._decode_bias)
