"""The port's Whisper speech encoder-decoder (``models/whisper.py``: the
full, encoder, decoder and KV-cache decode-step graphs; the Conv1d mel
front end, sinusoid positions, pre-LN layers, pre-scaled attention) and
``generate_seq2seq`` from float features, held against the live
``transformers`` module and the JAX package on JAX's tiny config (8 mel
bins, d_model 32, 2 + 2 layers, 2 heads, ffn 64, vocabulary 96, 15 source
and 16 target positions; B=2, features [2, 8, 30], target 8), in TPU-mode
numerics (x64 off). JAX builds its graphs from the module; the port builds
its own from the module's ``state_dict()`` as numpy.

Tolerances: the four graphs equal JAX's node for node with equal
initializers. ``random_whisper_weights``' sinusoid table (numpy) lies
within 2e-5 of HF's torch table at Whisper-tiny's 1500 x 384 (float32 exp,
sin and cos round apart in the last ulp) and within 1e-6 at the tiny
config's. Float outputs lie within 2e-5 of the module's and 1e-5 *
max|output| of JAX's; the encoder and decoder graphs compose to the full
graph's logits bit for bit. With one set of calibration stats (the port's,
for both), ``optimize()`` leaves JAX's report (6 head-split fusions: the
pre-scaled encoder self, causal decoder self and cross; no failure) and the
fused f32 forward equals the unfused one bit for bit. Greedy tokens equal
the module's full re-forward loop and JAX's, float and int8 (on the port's
stats, JAX's quantized state installed with ``load_jax_params``), through
``generate_seq2seq`` and through the decode step under ``generate_kv(...,
memory=)``, whose int8 KV cache gives the float carry's tokens.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from transformers.models.whisper.modeling_whisper import sinusoids

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import whisper as JW
from numpy_quant_tpu.utils import generate_seq2seq as j_generate_seq2seq
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.models import whisper as TW
from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                         generate_seq2seq,
                                         merge_calibration_stats)
from .torch_parity import assert_same_graph, greedy_hf, jax_state

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

B, T, NEW = 2, 8, 6
FORMS = {"seq2seq": dict(tgt_len=T), "encoder": {},
         "decoder": dict(tgt_len=T), "decode_step": dict(max_len=T)}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def wh():
    m = JW.whisper_tiny_module(seed=0)
    w = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
    cfg = {k: getattr(m.config, k) for k in TW.WHISPER_TINY}
    with jax.enable_x64(False):
        jp = {f: getattr(JW, f"whisper_{f}")(batch_size=B, module=m, **kw)
              for f, kw in FORMS.items()}
    tp = {f: getattr(TW, f"whisper_{f}")(w, cfg, batch_size=B, **kw)
          for f, kw in FORMS.items()}
    rng = np.random.default_rng(53)
    return dict(m=m, w=w, cfg=cfg, jp=jp, tp=tp, rng=rng,
                start=int(m.config.decoder_start_token_id),
                feats=rng.normal(size=(B, 8, 30)).astype(np.float32) * 0.5,
                xd=rng.normal(size=(B, T, 32)).astype(np.float32))


def _port(wh, form):
    return Model.from_onnx(wh["tp"][form], device="cpu")


def _jax(wh, form):
    return nq.Model.from_onnx(wh["jp"][form])


@pytest.mark.parametrize("form", list(FORMS))
def test_graphs_equal_jax(wh, form):
    assert_same_graph(wh["tp"][form], wh["jp"][form])
    np.testing.assert_array_equal(wh["tp"][form]._wte, wh["jp"][form]._wte)


@pytest.mark.parametrize("length,channels,tol", [(15, 32, 1e-6),
                                                 (1500, 384, 2e-5)])
def test_random_weights_load_into_hf(wh, length, channels, tol):
    """random_whisper_weights is an HF state dict with HF's init (the
    encoder's table Whisper's sinusoids); the published widths build."""
    np.testing.assert_allclose(TW.sinusoids(length, channels),
                               sinusoids(length, channels).numpy(), rtol=0,
                               atol=tol)
    w = TW.random_whisper_weights(wh["cfg"], seed=0)
    assert set(w) == set(wh["w"])
    wh["m"].__class__(wh["m"].config).load_state_dict(
        {k: torch.from_numpy(v) for k, v in w.items()})
    assert w["proj_out.weight"] is w["model.decoder.embed_tokens.weight"]
    assert TW.WHISPER_TINY["max_source_positions"] == 1500
    assert TW.WHISPER_TINY["d_model"] == 384


def test_outputs_match_module_and_jax(wh):
    """The encoder's memory and the full graph's logits match the module
    and JAX; the encoder and decoder graphs compose to the full logits."""
    feats, xd = wh["feats"], wh["xd"]
    memory = _port(wh, "encoder")([feats])[0]
    got = _port(wh, "seq2seq")([feats, xd])[0]
    with torch.no_grad():
        want_mem = wh["m"].model.encoder(torch.from_numpy(feats)) \
            .last_hidden_state.numpy()
        want = wh["m"](input_features=torch.from_numpy(feats),
                       decoder_inputs_embeds=torch.from_numpy(xd)) \
            .logits.numpy()
    np.testing.assert_allclose(memory, want_mem, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    jout = np.asarray(_jax(wh, "seq2seq")([feats, xd])[0])
    np.testing.assert_allclose(got, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())
    np.testing.assert_array_equal(_port(wh, "decoder")([xd, memory])[0], got)


def test_optimize_matches_jax_and_fused_equals_unfused(wh):
    feats, xd = wh["feats"], wh["xd"]
    tm = _port(wh, "seq2seq")
    stats = tm.calibration_stats([feats, xd])
    jrep = _jax(wh, "seq2seq").quantize(bit_width=8, stats=stats).optimize()
    tq = tm.quantize(bit_width=8, stats=stats)
    unfused = tq([feats, xd])[0]
    rep = tq.optimize()
    assert rep == {k: jrep[k] for k in rep}
    assert rep["fuse_attention"] == 6 and rep["fusion_failures"] == []
    np.testing.assert_array_equal(tq([feats, xd])[0], unfused)


def _greedy(wh):
    return greedy_hf(wh["m"], wh["start"], NEW, input_features=wh["feats"])


def test_generate_seq2seq_matches_jax_and_module(wh):
    """Float features feed the encoder directly; float tokens equal the
    module's and JAX's, int8 tokens JAX's."""
    feats, wte, start = wh["feats"], wh["tp"]["decoder"]._wte, wh["start"]
    tenc, tdec = _port(wh, "encoder"), _port(wh, "decoder")
    got = generate_seq2seq(tenc, tdec, feats, wte, NEW,
                           decoder_start_id=start)
    np.testing.assert_array_equal(got, _greedy(wh))
    np.testing.assert_array_equal(
        got, j_generate_seq2seq(_jax(wh, "encoder"), _jax(wh, "decoder"),
                                feats, wte, NEW, decoder_start_id=start))
    enc_stats = tenc.calibration_stats([feats])
    xd = wte[np.full((B, T), start)].astype(np.float32)
    dec_stats = tdec.calibration_stats([xd, tenc([feats])[0]])
    pair = []
    for form, stats in (("encoder", enc_stats), ("decoder", dec_stats)):
        # JAX's unfused forward: its fused one equals it bit for bit
        jq = _jax(wh, form).quantize(bit_width=8, stats=stats)
        tq = _port(wh, form).quantize(bit_width=8, stats=stats)
        load_jax_params(tq, jax_state(jq))
        assert tq.optimize()["fusion_failures"] == []
        pair.append((tq, jq))
    (tqe, jqe), (tqd, jqd) = pair
    np.testing.assert_array_equal(
        generate_seq2seq(tqe, tqd, feats, wte, NEW, decoder_start_id=start),
        j_generate_seq2seq(jqe, jqd, feats, wte, NEW, decoder_start_id=start))


def test_decode_step_matches_module_and_jax(wh):
    """The KV-cache step under generate_kv(memory=) decodes the module's
    greedy tokens in float; quantized on memory-aware decode_calibration
    stats with JAX's state, its int8 tokens equal JAX's, with a float and
    an int8 cache."""
    step_p, start = wh["tp"]["decode_step"], wh["start"]
    wte, wpe = step_p._wte, step_p._wpe
    memory = _port(wh, "encoder")([wh["feats"]])[0]
    prompt = np.full((B, 1), start, np.int32)
    step = _port(wh, "decode_step")
    np.testing.assert_array_equal(
        generate_kv(step, prompt, wte, wpe, NEW, memory=memory), _greedy(wh))
    qprompt = np.concatenate(
        [prompt, wh["rng"].integers(0, 96, size=(B, 2)).astype(np.int32)],
        axis=1)
    batches = decode_calibration(step, qprompt, wte, wpe, memory=memory)
    stats = merge_calibration_stats(*[step.calibration_stats(b)
                                      for b in batches])
    jq = _jax(wh, "decode_step").quantize(stats=stats, bit_width=8)
    j_ids = JGEN.generate_kv(jq, qprompt, wte, wpe, 4, memory=memory)
    tq = step.quantize(stats=stats, bit_width=8)
    load_jax_params(tq, jax_state(jq))
    for cache in (None, "int8"):
        np.testing.assert_array_equal(
            generate_kv(tq, qprompt, wte, wpe, 4, memory=memory,
                        kv_cache_dtype=cache), j_ids)
