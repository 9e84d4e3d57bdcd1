"""The port's Mixtral-style sparse MoE (``models/moe.py``: the full causal
LM and the KV-cache decode step), held against the live ``transformers``
module and the JAX package on JAX's tiny config (hidden 32, 2 layers, 4
heads, 2 KV heads, 4 experts, top-2, vocabulary 96; B=2, N=16), in
TPU-mode numerics (x64 off). JAX builds its graphs from the module; the
port builds its own from the module's ``state_dict()`` as numpy.

Tolerances: both graphs equal JAX's node for node with equal
initializers and RoPE tables. Float logits lie within 2e-5 of the
module's (HF's sparse index_add dispatch: unselected experts multiply by
exactly 0.0) and 1e-5 * max|logit| of JAX's. Greedy tokens of the full
form (``generate``) and of the step (``generate_kv(rope=)``) equal JAX's
and each other's. On one set of stats, ``optimize()`` leaves JAX's report
on both forms (2 plain fusions on the full form, 2 DecodeAttention on the
step; the router Softmaxes decline) and the fused f32 forward equals the
unfused one bit for bit.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import moe as JE
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.models import moe as TE
from numpy_quant_tpu_torch.utils import (decode_calibration, generate,
                                         generate_kv)
from .torch_parity import assert_same_graph

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

B, N, H, V = 2, 16, 32, 96
PROMPT, NEW = 5, 8


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def moe():
    with jax.enable_x64(False):
        jp = JE.mixtral_causal_lm(batch_size=B, seq_len=N, seed=0)
        m = jp._torch_module
        js = JE.mixtral_decode_step(batch_size=B, max_len=N, module=m)
    w = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
    cfg = TE.default_config(N)
    rng = np.random.default_rng(53)
    return dict(m=m, w=w, cfg=cfg, jp=jp, js=js,
                tp=TE.mixtral_causal_lm(w, cfg, batch_size=B, seq_len=N),
                ts=TE.mixtral_decode_step(w, cfg, batch_size=B, max_len=N),
                x=rng.normal(size=(B, N, H)).astype(np.float32),
                prompt=rng.integers(0, V, (B, PROMPT)).astype(np.int32))


def test_graphs_equal_jax(moe):
    assert_same_graph(moe["tp"], moe["jp"])
    assert_same_graph(moe["ts"], moe["js"])
    for got, want in zip(moe["ts"]._rope_tables, moe["js"]._rope_tables):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(moe["tp"]._wte, moe["jp"]._wte)


def test_random_weights_load_into_hf(moe):
    """random_mixtral_weights is the module's state dict; num_layers cuts
    the depth; MIXTRAL_8X7B holds the published widths."""
    w = TE.random_mixtral_weights(moe["cfg"], seed=0)
    assert set(w) == set(moe["w"])
    moe["m"].__class__(moe["m"].config).load_state_dict(
        {k: torch.from_numpy(v) for k, v in w.items()})
    one = TE.random_mixtral_weights(moe["cfg"], seed=0, num_layers=1)
    assert not any(k.startswith("model.layers.1.") for k in one)
    cfg = TE.MIXTRAL_8X7B
    assert (cfg["hidden_size"], cfg["intermediate_size"],
            cfg["num_local_experts"], cfg["num_experts_per_tok"],
            cfg["num_key_value_heads"], cfg["rope_theta"]) == (
        4096, 14336, 8, 2, 8, 1e6)


def test_logits_match_module_and_jax(moe):
    x = moe["x"]
    got = Model.from_onnx(moe["tp"], device="cpu")([x])[0]
    with torch.no_grad():
        want = moe["m"](inputs_embeds=torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    jout = np.asarray(nq.Model.from_onnx(moe["jp"])([x])[0])
    np.testing.assert_allclose(got, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())


def test_greedy_tokens_match_jax_full_and_step(moe):
    prompt, wte = moe["prompt"], moe["tp"]._wte
    full = generate(Model.from_onnx(moe["tp"], device="cpu"), prompt, wte,
                    NEW)
    np.testing.assert_array_equal(full, JGEN.generate(
        nq.Model.from_onnx(moe["jp"]), prompt, wte, NEW))
    step = generate_kv(Model.from_onnx(moe["ts"], device="cpu"), prompt,
                       wte, None, NEW, rope=moe["ts"]._rope_tables)
    np.testing.assert_array_equal(step, full)


def test_step_optimize_report_matches_jax(moe):
    """The decode step on one set of stats: JAX's report (2
    DecodeAttention fusions; the router Softmaxes decline). The Softmaxes
    DecodeAttention fused leave the port's failures list; JAX's keeps
    fuse_attention's entries for them (as tests/test_torch_t5_decode.py
    holds for T5)."""
    step = Model.from_onnx(moe["ts"], device="cpu")
    inputs = [t.numpy() for t in decode_calibration(
        step, moe["prompt"], moe["ts"]._wte, None,
        rope=moe["ts"]._rope_tables)[-1]]
    stats = step.calibration_stats(inputs)
    jrep = nq.Model.from_onnx(moe["js"]).quantize(
        bit_width=8, stats=stats).optimize()
    rep = step.quantize(bit_width=8, stats=stats).optimize()
    fused_sm = {f"Softmaxlayers.{i}.self_attn/probs" for i in range(2)}
    jrep["fusion_failures"] = [f for f in jrep["fusion_failures"]
                               if f[0] not in fused_sm]
    assert rep == {k: jrep[k] for k in rep}
    assert rep["fuse_decode_attention"] == 2
    assert [r for _, r in rep["fusion_failures"]] == [
        "softmax output does not feed exactly one MatMul as its lhs"] * 2


def test_optimize_matches_jax_and_fused_equals_unfused(moe):
    rng = np.random.default_rng(2)
    calib = moe["tp"]._wte[rng.integers(0, V, (B, N))].astype(np.float32)
    tm = Model.from_onnx(moe["tp"], device="cpu")
    stats = tm.calibration_stats([calib])
    jrep = nq.Model.from_onnx(moe["jp"]).quantize(
        bit_width=8, stats=stats).optimize()
    tq = tm.quantize(bit_width=8, stats=stats)
    unfused = tq([calib])[0]
    rep = tq.optimize()
    assert rep == {k: jrep[k] for k in rep}
    assert rep["fuse_attention"] == 2
    assert [r for _, r in rep["fusion_failures"]] == [
        "softmax output does not feed exactly one MatMul as its lhs"] * 2
    np.testing.assert_array_equal(tq([calib])[0], unfused)
