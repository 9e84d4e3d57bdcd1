"""The port's Mamba (``models/mamba.py``: the full and the state-carry
decode-step graphs), ``generate_mamba``, ``mamba_decode_calibration`` and
the engine's ``state_carry`` layout, held against the live
``transformers`` module and the JAX package on JAX's tiny config (hidden
32, state 4, 2 layers, conv 4, expand 2, dt rank 8, vocabulary 96; B=2,
L=8), in TPU-mode numerics (x64 off). JAX builds its graphs from the
module; the port builds its own from the module's ``state_dict()`` as
numpy.

Tolerances: both graphs equal JAX's node for node with equal
initializers. Float logits lie within 1e-5 * max|logit| of JAX's and 2e-4
of the module's. On one set of stats (the port's), the int8 full form's
quantized constants and qparams equal JAX's and its integer intermediates
equal JAX's bit for bit; ``optimize()`` leaves JAX's report on both
forms. ``generate_mamba`` tokens equal JAX's and the
module's greedy loop in float, and JAX's in int8 (JAX's quantized state
installed with ``load_jax_params``); ``mamba_decode_calibration``'s
inputs lie within 1e-5 * max of JAX's. The engine's tokens equal
``generate_mamba``'s for each request alone.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import mamba as JM
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.models import mamba as TM
from numpy_quant_tpu_torch.utils import (ContinuousBatcher, generate,
                                         generate_mamba,
                                         mamba_decode_calibration,
                                         merge_calibration_stats)
from .torch_parity import (assert_integers_equal, assert_same_graph,
                           jax_qvalues, jax_state)

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

B, L, H, V = 2, 8, 32, 96
PROMPT, NEW = 3, 5


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _rel_close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def mamba():
    m = JM.mamba_tiny_module(seed=0)
    w = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
    cfg = TM.tiny_config()
    rng = np.random.default_rng(59)
    with jax.enable_x64(False):
        jp = JM.mamba_causal_lm(batch_size=B, seq_len=L, module=m)
        js = JM.mamba_decode_step(batch_size=B, module=m)
    return dict(m=m, w=w, cfg=cfg, jp=jp, js=js, rng=rng,
                tp=TM.mamba_causal_lm(w, cfg, batch_size=B, seq_len=L),
                ts=TM.mamba_decode_step(w, cfg, batch_size=B),
                x=rng.normal(size=(B, L, H)).astype(np.float32) * 0.3,
                prompt=rng.integers(0, V, (B, PROMPT)).astype(np.int32))


def test_graphs_equal_jax(mamba):
    assert_same_graph(mamba["tp"], mamba["jp"])
    assert_same_graph(mamba["ts"], mamba["js"])
    np.testing.assert_array_equal(mamba["ts"]._wte, mamba["js"]._wte)


def test_random_weights_load_into_hf(mamba):
    """random_mamba_weights is the module's state dict (the tied head
    aside) with HF's init; MAMBA_130M holds the published widths."""
    w = TM.random_mamba_weights(mamba["cfg"], seed=0)
    assert set(w) | {"lm_head.weight"} == set(mamba["w"])
    mamba["m"].__class__(mamba["m"].config).load_state_dict(
        {k: torch.from_numpy(v) for k, v in w.items()}, strict=False)
    np.testing.assert_array_equal(
        np.exp(w["backbone.layers.0.mixer.A_log"][0]), np.arange(1, 5))
    cfg = TM.MAMBA_130M
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["state_size"],
            cfg["time_step_rank"], cfg["vocab_size"]) == (768, 24, 16, 48,
                                                          50280)


def test_logits_match_module_and_jax(mamba):
    x = mamba["x"]
    got = Model.from_onnx(mamba["tp"], device="cpu")([x])[0]
    with torch.no_grad():
        want = mamba["m"](inputs_embeds=torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    _rel_close(got, nq.Model.from_onnx(mamba["jp"])([x])[0])


def test_int8_intermediates_equal_jax(mamba):
    """4 projections x 2 layers + L scan products x 2 + the head
    quantize; on shared stats every integer value equals JAX's."""
    x = mamba["x"]
    tm = Model.from_onnx(mamba["tp"], device="cpu")
    stats = tm.calibration_stats([x])
    tq = tm.quantize(bit_width=8, stats=stats)
    assert sum(n.op == "MatMul" for n in tq.nodes) == 4 * 2 + L * 2 + 1
    jq = nq.Model.from_onnx(mamba["jp"]).quantize(bit_width=8, stats=stats)
    state = jax_state(jq)
    for v in tq.values:
        if v.name in state["constants"]:
            np.testing.assert_array_equal(
                v.data.data.numpy(), state["constants"][v.name]["payload"],
                err_msg=v.name)
    tq([x], record=True)
    assert assert_integers_equal(tq, jax_qvalues(jq, [x])) > 4 * 2 + L * 2


def test_generate_mamba_matches_module_and_jax(mamba):
    """The state-carry step decodes the module's greedy tokens, JAX's
    and the full graph's generate."""
    prompt, wte = mamba["prompt"], mamba["ts"]._wte
    step = Model.from_onnx(mamba["ts"], device="cpu")
    got = generate_mamba(step, prompt, wte, NEW)
    ids = prompt.astype(np.int64)
    with torch.no_grad():
        for _ in range(NEW):
            logits = mamba["m"](input_ids=torch.from_numpy(ids)).logits
            ids = np.concatenate(
                [ids, logits[:, -1].argmax(-1).numpy()[:, None]], axis=1)
    np.testing.assert_array_equal(got, ids.astype(np.int32))
    np.testing.assert_array_equal(got, JGEN.generate_mamba(
        nq.Model.from_onnx(mamba["js"]), prompt, wte, NEW))
    np.testing.assert_array_equal(got, generate(
        Model.from_onnx(mamba["tp"], device="cpu"), prompt, wte, NEW))
    rows = []
    generate_mamba(step, prompt, wte, NEW, step_logits=rows)
    assert len(rows) == PROMPT + NEW - 1
    np.testing.assert_array_equal(
        np.stack([r.argmax(-1).numpy() for r in rows[PROMPT - 1:]], 1),
        got[:, PROMPT:])
    with pytest.raises(NotImplementedError, match="generator"):
        generate_mamba(step, prompt, wte, NEW, key=0)
    sampled = generate_mamba(step, prompt, wte, NEW, temperature=0.8,
                             top_k=5, repetition_penalty=1.3,
                             generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(sampled[:, :PROMPT], prompt)


@pytest.mark.parametrize("form", ["full", "step"])
def test_optimize_report_matches_jax(mamba, form):
    """On one set of stats, optimize() leaves JAX's report on both forms:
    no attention to fuse, the same int8 dataflow plan."""
    tp, jp = (mamba["tp"], mamba["jp"]) if form == "full" \
        else (mamba["ts"], mamba["js"])
    tm = Model.from_onnx(tp, device="cpu")
    if form == "full":
        inputs = [mamba["x"]]
    else:
        inputs = [t.numpy() for t in mamba_decode_calibration(
            tm, mamba["prompt"], tp._wte)[-1]]
    stats = tm.calibration_stats(inputs)
    jrep = nq.Model.from_onnx(jp).quantize(bit_width=8, stats=stats) \
        .optimize()
    rep = tm.quantize(bit_width=8, stats=stats).optimize()
    assert rep == {k: jrep[k] for k in rep}
    assert rep["fuse_attention"] == 0 and rep["int8_dataflow"] > 0


@pytest.fixture(scope="module")
def int8_step(mamba):
    """(port int8 step with JAX's quantized state, JAX int8 step, JAX
    calibration batches, port batches) on the port's merged stats."""
    prompt, wte = mamba["prompt"], mamba["ts"]._wte
    step = Model.from_onnx(mamba["ts"], device="cpu")
    jstep = nq.Model.from_onnx(mamba["js"])
    batches = mamba_decode_calibration(step, prompt, wte)
    stats = merge_calibration_stats(*[step.calibration_stats(b)
                                      for b in batches])
    with jax.enable_x64(False):
        jb = JGEN.mamba_decode_calibration(jstep, prompt, wte)
        jq = jstep.quantize(bit_width=8, stats=stats)
    tq = step.quantize(bit_width=8, stats=stats)
    load_jax_params(tq, jax_state(jq))
    return tq, jq, jb, batches


def test_decode_calibration_matches_jax(int8_step):
    _, _, jb, batches = int8_step
    assert len(batches) == len(jb) == PROMPT
    for tb, jbt in zip(batches, jb):
        assert len(tb) == len(jbt) == 1 + 2 * 2
        for got, want in zip(tb, jbt):
            if np.abs(want).max() == 0:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                _rel_close(got.numpy(), want)


def test_int8_generate_mamba_matches_jax(mamba, int8_step):
    tq, jq, _, _ = int8_step
    prompt, wte = mamba["prompt"], mamba["ts"]._wte
    got = generate_mamba(tq, prompt, wte, NEW)
    np.testing.assert_array_equal(got, JGEN.generate_mamba(jq, prompt, wte,
                                                           NEW))
    np.testing.assert_array_equal(got[:, :PROMPT], prompt)


@pytest.mark.parametrize("quantized", [False, True])
def test_state_carry_engine_matches_generate_mamba(mamba, int8_step,
                                                   quantized):
    """8 ragged requests over B slots: each request's tokens equal
    generate_mamba's for that request alone (admission zeroes the slot's
    carry rows); steps_per_sync=3 gives the same tokens."""
    step = int8_step[0] if quantized \
        else Model.from_onnx(mamba["ts"], device="cpu")
    wte = mamba["ts"]._wte
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, V, int(rng.integers(1, 4))).astype(np.int32),
             int(rng.integers(1, 6))) for _ in range(8)]
    out = ContinuousBatcher(step, wte, state_carry=True, max_len=12).run(reqs)
    for rid, (p, n) in enumerate(reqs):
        solo = generate_mamba(step, np.repeat(p[None], B, 0), wte, n)[0]
        np.testing.assert_array_equal(out[rid], solo, err_msg=str(rid))
    chunked = ContinuousBatcher(step, wte, state_carry=True, max_len=12,
                                steps_per_sync=3).run(reqs)
    assert all(np.array_equal(chunked[k], out[k]) for k in out)


@pytest.mark.parametrize("kw", [
    dict(wpe=np.zeros((4, H), np.float32)), dict(rope=(None, None)),
    dict(score_bias=np.zeros(1)), dict(has_memory=True),
    dict(kv_cache_dtype="int8"), dict(prefill_model=object()),
    dict(paged_kv=(4, 8)), dict(max_len=None)])
def test_state_carry_refusals(mamba, kw):
    """JAX's ValueErrors for the combinations a state carry cannot take."""
    step = Model.from_onnx(mamba["ts"], device="cpu")
    kw = dict(dict(max_len=12), **kw)
    with pytest.raises(ValueError, match="state_carry"):
        ContinuousBatcher(step, mamba["ts"]._wte, state_carry=True, **kw)
