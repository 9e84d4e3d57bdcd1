"""The port's BART encoder-decoder (``models/seq2seq.py``: the full,
encoder, decoder and KV-cache decode-step graphs) and ``generate_seq2seq``,
held against the live ``transformers`` module and the JAX package on JAX's
tiny config (d_model 32, 2 + 2 layers, 2 heads, ffn 64, vocabulary 96, 32
positions; B=2, source 12, target 8), in TPU-mode numerics (x64 off). JAX
builds its graphs from the module; the port builds its own from the
module's ``state_dict()`` as numpy.

Tolerances: the four graphs equal JAX's node for node with equal
initializers and position tables. Float logits lie within 2e-5 of the
module's and 1e-5 * max|logit| of JAX's; the encoder and decoder graphs
compose to the full graph's logits bit for bit. With one set of
calibration stats (the port's, for both), ``optimize()`` leaves JAX's report
(6 head-split fusions: 2 encoder self, 2 causal decoder self, 2 cross with 8
queries against 12 keys; no failure) and the fused f32 forward equals the
unfused one bit for bit. Greedy tokens equal the module's full re-forward
loop and JAX's, float and int8 (on the port's stats, JAX's quantized state
installed with ``load_jax_params``), through ``generate_seq2seq`` and
through the decode step under ``generate_kv(..., memory=)``, whose int8 KV
cache gives the float carry's tokens.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import seq2seq as JS
from numpy_quant_tpu.utils import generate_seq2seq as j_generate_seq2seq
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.models import seq2seq as TS
from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                         generate_seq2seq,
                                         merge_calibration_stats)
from .torch_parity import assert_same_graph, greedy_hf, jax_state

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

B, S, T, NEW = 2, 12, 8, 6
FORMS = {"seq2seq": dict(src_len=S, tgt_len=T), "encoder": dict(src_len=S),
         "decoder": dict(src_len=S, tgt_len=T),
         "decode_step": dict(max_len=T, src_len=S)}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def bart():
    m = JS.bart_tiny_module(seed=0)
    w = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
    cfg = {k: getattr(m.config, k) for k in TS.BART_BASE}
    with jax.enable_x64(False):
        jp = {f: getattr(JS, f"bart_{f}")(batch_size=B, module=m, **kw)
              for f, kw in FORMS.items()}
    tp = {f: getattr(TS, f"bart_{f}")(w, cfg, batch_size=B, **kw)
          for f, kw in FORMS.items()}
    rng = np.random.default_rng(31)
    src = rng.integers(4, 96, size=(B, S)).astype(np.int32)
    return dict(m=m, w=w, cfg=cfg, jp=jp, tp=tp, src=src, rng=rng,
                start=int(m.config.decoder_start_token_id),
                xe=rng.normal(size=(B, S, 32)).astype(np.float32),
                xd=rng.normal(size=(B, T, 32)).astype(np.float32))


def _port(bart, form):
    return Model.from_onnx(bart["tp"][form], device="cpu")


def _jax(bart, form):
    return nq.Model.from_onnx(bart["jp"][form])


@pytest.mark.parametrize("form", list(FORMS))
def test_graphs_equal_jax(bart, form):
    assert_same_graph(bart["tp"][form], bart["jp"][form])
    for table in ("_wte", "_enc_pos", "_dec_pos"):
        np.testing.assert_array_equal(getattr(bart["tp"][form], table),
                                      getattr(bart["jp"][form], table))


def test_random_weights_load_into_hf(bart):
    """random_bart_weights is an HF state dict with HF's init scales; the
    published widths build."""
    w = TS.random_bart_weights(bart["cfg"], seed=0)
    assert set(w) == set(bart["w"])
    bart["m"].__class__(bart["m"].config).load_state_dict(
        {k: torch.from_numpy(v) for k, v in w.items()})
    assert w["lm_head.weight"] is w["model.shared.weight"]
    assert np.all(w["model.shared.weight"][1] == 0)
    assert abs(float(w["model.encoder.layers.0.fc1.weight"].std())
               - 0.02) < 2e-3
    assert TS.BART_BASE["d_model"] == 768 and TS.BART_BASE["vocab_size"] \
        == 50265
    with pytest.raises(ValueError, match="activation"):
        TS.random_bart_weights({"activation_function": "relu"})


def test_logits_match_module_and_jax(bart):
    """The full graph's float logits match the module and JAX; the encoder
    and decoder graphs compose to them bit for bit."""
    xe, xd = bart["xe"], bart["xd"]
    got = _port(bart, "seq2seq")([xe, xd])[0]
    with torch.no_grad():
        want = bart["m"](inputs_embeds=torch.from_numpy(xe),
                         decoder_inputs_embeds=torch.from_numpy(xd)) \
            .logits.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    jout = np.asarray(_jax(bart, "seq2seq")([xe, xd])[0])
    np.testing.assert_allclose(got, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())
    memory = _port(bart, "encoder")([xe])[0]
    np.testing.assert_array_equal(_port(bart, "decoder")([xd, memory])[0],
                                  got)


def test_optimize_matches_jax_and_fused_equals_unfused(bart):
    xe, xd = bart["xe"], bart["xd"]
    tm = _port(bart, "seq2seq")
    stats = tm.calibration_stats([xe, xd])
    jrep = _jax(bart, "seq2seq").quantize(bit_width=8, stats=stats).optimize()
    tq = tm.quantize(bit_width=8, stats=stats)
    unfused = tq([xe, xd])[0]
    rep = tq.optimize()
    assert rep == {k: jrep[k] for k in rep}
    assert rep["fuse_attention"] == 6 and rep["fusion_failures"] == []
    np.testing.assert_array_equal(tq([xe, xd])[0], unfused)


def _quantized_pair(bart):
    """(port encoder, port decoder, JAX int8 tokens): both halves quantized
    on one set of stats with JAX's quantized state installed, the port's
    optimize()d."""
    wte = bart["jp"]["encoder"]._wte
    xe = wte[bart["src"]]
    tenc = _port(bart, "encoder")
    enc_stats = tenc.calibration_stats([xe])
    memory = tenc([xe])[0]
    xd = wte[np.full((B, T), bart["start"])].astype(np.float32)
    dec_stats = _port(bart, "decoder").calibration_stats([xd, memory])
    ports = []
    for form, stats in (("encoder", enc_stats), ("decoder", dec_stats)):
        # JAX's unfused forward: its fused one equals it bit for bit
        jq = _jax(bart, form).quantize(bit_width=8, stats=stats)
        tq = _port(bart, form).quantize(bit_width=8, stats=stats)
        load_jax_params(tq, jax_state(jq))
        assert tq.optimize()["fusion_failures"] == []
        ports.append((tq, jq))
    (tenc, jqe), (tdec, jqd) = ports
    j_ids = j_generate_seq2seq(jqe, jqd, bart["src"], wte, NEW,
                               decoder_start_id=bart["start"])
    return tenc, tdec, np.asarray(j_ids)


def test_generate_seq2seq_matches_jax_and_module(bart):
    wte, start = bart["tp"]["decoder"]._wte, bart["start"]
    got = generate_seq2seq(_port(bart, "encoder"), _port(bart, "decoder"),
                           bart["src"], wte, NEW, decoder_start_id=start)
    want = greedy_hf(bart["m"], start, NEW,
                     input_ids=bart["src"].astype(np.int64))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, j_generate_seq2seq(_jax(bart, "encoder"), _jax(bart, "decoder"),
                                bart["src"], wte, NEW, decoder_start_id=start))
    with pytest.raises(ValueError, match="fixed length"):
        generate_seq2seq(_port(bart, "encoder"), _port(bart, "decoder"),
                         bart["src"], wte, T, decoder_start_id=start)
    tenc, tdec, j_ids = _quantized_pair(bart)
    q_ids = generate_seq2seq(tenc, tdec, bart["src"], wte, NEW,
                             decoder_start_id=start)
    np.testing.assert_array_equal(q_ids, j_ids)


def test_decode_step_matches_module_and_jax(bart):
    """The KV-cache step under generate_kv(memory=) decodes the module's
    greedy tokens in float; quantized on memory-aware decode_calibration
    stats with JAX's state, its int8 tokens equal JAX's, with a float and
    an int8 cache."""
    step_p, start = bart["tp"]["decode_step"], bart["start"]
    wte, wpe = step_p._wte, step_p._dec_pos
    memory = _port(bart, "encoder")([wte[bart["src"]]])[0]
    prompt = np.full((B, 1), start, np.int32)
    step = _port(bart, "decode_step")
    got = generate_kv(step, prompt, wte, wpe, NEW, memory=memory)
    np.testing.assert_array_equal(
        got, greedy_hf(bart["m"], start, NEW,
                       input_ids=bart["src"].astype(np.int64)))
    qprompt = np.concatenate(
        [prompt, bart["rng"].integers(4, 96, size=(B, 2)).astype(np.int32)],
        axis=1)
    batches = decode_calibration(step, qprompt, wte, wpe, memory=memory)
    assert len(batches) == qprompt.shape[1]
    for tb in batches:
        np.testing.assert_array_equal(tb[2].numpy(), memory)
    stats = merge_calibration_stats(*[step.calibration_stats(b)
                                      for b in batches])
    jq = _jax(bart, "decode_step").quantize(stats=stats, bit_width=8)
    j_ids = JGEN.generate_kv(jq, qprompt, wte, wpe, 4, memory=memory)
    tq = step.quantize(stats=stats, bit_width=8)
    load_jax_params(tq, jax_state(jq))
    for cache in (None, "int8"):
        np.testing.assert_array_equal(
            generate_kv(tq, qprompt, wte, wpe, 4, memory=memory,
                        kv_cache_dtype=cache), j_ids)
