"""The port's BERT text classifier (``models/text.py``), held against the
live ``transformers`` BertForSequenceClassification and the JAX package
on JAX's tiny config (hidden 32, 2 layers, 2 heads, intermediate 64,
vocabulary 96, 4 labels; B=8, 16 tokens), in TPU-mode numerics (x64 off).
JAX builds its graph from the module; the port builds its own from the
module's ``state_dict()`` as numpy.

Tolerances: the graph equals JAX's node for node with equal initializers.
Float logits lie within 2e-4 of the module's and 1e-5 * max|logit| of
JAX's. On one set of stats, ``optimize()`` leaves JAX's report (2
head-split fusions, no failure), the fused f32 forward equals the
unfused one bit for bit, the int8 labels equal float's, and after
``pack_weights()`` the logits are unchanged. Device int64 ids (a
``DITensor`` through the Gather) give the host ids' logits.
"""
import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.models.text import bert_text_classifier as j_bert
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.models import text as TT
from .torch_parity import assert_same_graph

B, T, V = 8, 16, 96


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def port_config(config) -> dict:
    """BERT_BASE's keys from an HF BertConfig."""
    return {k: getattr(config, k) for k in TT.BERT_BASE
            if k != "initializer_range"}


@pytest.fixture(scope="module")
def bert():
    with jax.enable_x64(False):
        jp = j_bert(batch_size=B, seq_len=T, seed=1)
    m = jp._torch_module
    w = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()
         if not k.endswith(("position_ids", "token_type_ids"))}
    cfg = port_config(m.config)
    ids = np.random.default_rng(61).integers(0, V, (B, T)).astype(np.int64)
    return dict(m=m, w=w, cfg=cfg, jp=jp, ids=ids,
                tp=TT.bert_text_classifier(w, cfg, batch_size=B, seq_len=T))


def test_graph_equals_jax(bert):
    assert_same_graph(bert["tp"], bert["jp"])


def test_random_weights_load_into_hf(bert):
    """random_bert_weights is the module's state dict; BERT_BASE holds the
    published widths."""
    w = TT.random_bert_weights(bert["cfg"], seed=0)
    assert set(w) == set(bert["w"])
    bert["m"].__class__(bert["m"].config).load_state_dict(
        {k: torch.from_numpy(v) for k, v in w.items()}, strict=False)
    cfg = TT.BERT_BASE
    assert (cfg["vocab_size"], cfg["hidden_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["intermediate_size"],
            cfg["max_position_embeddings"]) == (30522, 768, 12, 12, 3072,
                                                512)


def test_logits_match_module_and_jax(bert):
    ids = bert["ids"]
    tm = Model.from_onnx(bert["tp"], device="cpu")
    got = tm([ids])[0]
    with torch.no_grad():
        want = bert["m"](input_ids=torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    jout = np.asarray(nq.Model.from_onnx(bert["jp"])([ids])[0])
    np.testing.assert_allclose(got, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())
    np.testing.assert_array_equal(tm([torch.from_numpy(ids)])[0], got)


def test_quantized_fused_and_packed(bert):
    ids = bert["ids"]
    tm = Model.from_onnx(bert["tp"], device="cpu")
    f_out = tm([ids])[0]
    stats = tm.calibration_stats([ids])
    jrep = nq.Model.from_onnx(bert["jp"]).quantize(
        bit_width=8, stats=stats).optimize()
    tq = tm.quantize(bit_width=8, stats=stats)
    base = tq([ids])[0]
    np.testing.assert_array_equal(base.argmax(-1), f_out.argmax(-1))
    rep = tq.optimize()
    assert rep == {k: jrep[k] for k in rep}
    assert rep["fuse_attention"] == 2 and rep["fusion_failures"] == []
    np.testing.assert_array_equal(tq([ids])[0], base)
    assert tq.pack_weights() > 0
    np.testing.assert_array_equal(tq([ids])[0], base)
    np.testing.assert_array_equal(tq([torch.from_numpy(ids)])[0], base)
