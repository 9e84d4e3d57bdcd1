"""The port's CLIP dual encoder (``models/clip.py``), held against the live
``transformers`` CLIPModel and the JAX package on JAX's tiny config (both
towers hidden 32, 2 layers, 4 heads, MLP 48; 16 px images in 8 px
patches; 8 text positions, vocabulary 96; projection 24; 2 images, 3
prompts), in TPU-mode numerics (x64 off). JAX builds its graph from the
module; the port builds its own from the module's ``state_dict()`` as
numpy.

Tolerances: the graph equals JAX's node for node with equal initializers
and embedding tables. ``logits_per_image`` lies within 1e-5 * max|logit|
of JAX's and 1e-5 of the module's, the embeddings within 1e-6 of both and
at unit norm. On one set of stats, ``optimize()`` leaves JAX's report (4
head-split fusions: 2 vision, 2 causal text; no failure), the fused f32
forward equals the unfused one bit for bit, and the int8 forward's top-1
prompt per image agrees with float on at least half the images.
"""
import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import clip as JC
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.models import clip as TC
from .torch_parity import assert_same_graph

BI, BT, T = 2, 3, 8


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _port_config(config) -> dict:
    """CLIP_VIT_B32's layout from an HF CLIPConfig."""
    keys = {"vision": ("hidden_size", "num_hidden_layers",
                       "num_attention_heads", "intermediate_size",
                       "image_size", "patch_size", "layer_norm_eps"),
            "text": ("hidden_size", "num_hidden_layers",
                     "num_attention_heads", "intermediate_size",
                     "vocab_size", "max_position_embeddings",
                     "layer_norm_eps")}
    return {"vision": {k: getattr(config.vision_config, k)
                       for k in keys["vision"]},
            "text": {k: getattr(config.text_config, k)
                     for k in keys["text"]},
            "projection_dim": config.projection_dim,
            "logit_scale_init_value": config.logit_scale_init_value}


@pytest.fixture(scope="module")
def clip():
    with jax.enable_x64(False):
        jp = JC.clip_dual_encoder(batch_images=BI, batch_texts=BT,
                                  seq_len=T, seed=0)
    m = jp._torch_module
    w = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()
         if not k.endswith("position_ids")}
    cfg = _port_config(m.config)
    tp = TC.clip_dual_encoder(w, cfg, batch_images=BI, batch_texts=BT,
                              seq_len=T)
    rng = np.random.default_rng(59)
    px = rng.normal(size=(BI, 3, 16, 16)).astype(np.float32)
    eos = m.config.text_config.eos_token_id
    ids = rng.integers(3, eos, size=(BT, T)).astype(np.int64)
    ids[:, -1] = eos  # pooling contract: EOS at the last position
    emb = (tp._wte[ids] + tp._wpe[np.arange(T)]).astype(np.float32)
    return dict(m=m, w=w, cfg=cfg, jp=jp, tp=tp, px=px, ids=ids, emb=emb)


def test_graph_equals_jax(clip):
    assert_same_graph(clip["tp"], clip["jp"])
    np.testing.assert_array_equal(clip["tp"]._wte, clip["jp"]._wte)
    np.testing.assert_array_equal(clip["tp"]._wpe, clip["jp"]._wpe)


def test_random_weights_load_into_hf(clip):
    """random_clip_weights is the module's state dict; CLIP_VIT_B32 holds
    the published widths."""
    w = TC.random_clip_weights(clip["cfg"], seed=0)
    assert set(w) == set(clip["w"])
    clip["m"].__class__(clip["m"].config).load_state_dict(
        {k: torch.from_numpy(v) for k, v in w.items()}, strict=False)
    v, t = TC.CLIP_VIT_B32["vision"], TC.CLIP_VIT_B32["text"]
    assert (v["hidden_size"], v["patch_size"], v["image_size"],
            t["hidden_size"], t["num_attention_heads"], t["vocab_size"],
            t["max_position_embeddings"]) == (768, 32, 224, 512, 8, 49408,
                                              77)


def test_forward_matches_module_and_jax(clip):
    px, emb = clip["px"], clip["emb"]
    logits, img, txt = Model.from_onnx(clip["tp"], device="cpu")([px, emb])
    with torch.no_grad():
        want = clip["m"](input_ids=torch.from_numpy(clip["ids"]),
                         pixel_values=torch.from_numpy(px))
    np.testing.assert_allclose(logits, want.logits_per_image.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(img, want.image_embeds.numpy(), atol=1e-6)
    np.testing.assert_allclose(txt, want.text_embeds.numpy(), atol=1e-6)
    jl, ji, jt = (np.asarray(o) for o in
                  nq.Model.from_onnx(clip["jp"])([px, emb]))
    np.testing.assert_allclose(logits, jl, rtol=0,
                               atol=1e-5 * np.abs(jl).max())
    np.testing.assert_allclose(img, ji, rtol=0, atol=1e-6)
    np.testing.assert_allclose(txt, jt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(img, axis=-1), 1.0, rtol=1e-5)


def test_optimize_matches_jax_and_fused_equals_unfused(clip):
    px, emb = clip["px"], clip["emb"]
    tm = Model.from_onnx(clip["tp"], device="cpu")
    f_logits = tm([px, emb])[0]
    stats = tm.calibration_stats([px, emb])
    jrep = nq.Model.from_onnx(clip["jp"]).quantize(
        bit_width=8, stats=stats).optimize()
    tq = tm.quantize(bit_width=8, stats=stats)
    unfused = tq([px, emb])
    rep = tq.optimize()
    assert rep == {k: jrep[k] for k in rep}
    assert rep["fuse_attention"] == 4 and rep["fusion_failures"] == []
    fused = tq([px, emb])
    for a, b in zip(unfused, fused):
        np.testing.assert_array_equal(a, b)
    assert (fused[0].argmax(-1) == f_logits.argmax(-1)).mean() >= 0.5
