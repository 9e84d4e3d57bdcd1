"""BERT-style text classifier ONNX graph, built from numpy weights.

Port of ``numpy_quant_tpu/models/text.py::bert_text_classifier``: the same
nodes, value names, attributes, inputs and outputs, emitted from a state
dict in HuggingFace's ``BertForSequenceClassification`` key names
(``bert.encoder.layer.{i}.attention.self.query.weight``, ...) instead of a
live ``transformers`` module. int64 ``input_ids`` go through a Gather over
the word-embedding table, the position rows plus the all-zero token-type
row fold into one additive constant, the encoder layers are POST-LN (HF
Bert), and a tanh pooler over the first token feeds the classifier head.
The attention emits the head-split idiom ViT's does, so ``optimize()``
fuses it into the head-split kernel.
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder
from .vit import _f32, _ViTEmitter

# bert-base-uncased (huggingface.co/bert-base-uncased/config.json) with a
# 2-label classifier head
BERT_BASE = {
    "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 512, "type_vocab_size": 2, "num_labels": 2,
    "layer_norm_eps": 1e-12, "initializer_range": 0.02,
}


def _bert_encoder_layer(e: _ViTEmitter, x: str, key: str, name: str,
                        heads: int, head_size: int) -> str:
    """HF BertLayer: POST-LN -- attention -> Add+LN -> GELU MLP ->
    Add+LN."""
    g = e.g
    ctx = e.self_attention(x, f"{key}.attention.self", f"{name}.attention",
                           heads, head_size)
    att = e.linear3d(ctx, f"{key}.attention.output.dense",
                     f"{name}.attention.output")
    res1 = g.node("Add", [att, x], out=f"{name}/residual1")
    x1 = e.layernorm(res1, f"{key}.attention.output.LayerNorm",
                     f"{name}.attention.ln")
    inter = e.linear3d(x1, f"{key}.intermediate.dense",
                       f"{name}.intermediate")
    act = e.gelu(inter, f"{name}.gelu")
    out = e.linear3d(act, f"{key}.output.dense", f"{name}.output")
    res2 = g.node("Add", [out, x1], out=f"{name}/residual2")
    return e.layernorm(res2, f"{key}.output.LayerNorm", f"{name}.ln")


def bert_text_classifier(weights: dict, config: dict, batch_size: int = 4,
                         seq_len: int = 16) -> O.ModelProto:
    """BertForSequenceClassification over int64 ``input_ids`` [batch, seq]
    -> ``logits`` [batch, num_labels] (full attention, all-ones mask, zero
    token types, whose embedding row folds into the position table).
    ``config`` takes HF BertConfig's field names (``BERT_BASE``)."""
    cfg = dict(BERT_BASE, **config)
    hidden = int(cfg["hidden_size"])
    heads = int(cfg["num_attention_heads"])
    g = GraphBuilder("bert_text_classifier")
    e = _ViTEmitter(g, weights, cfg["layer_norm_eps"])
    ids = g.input("input_ids", [batch_size, seq_len],
                  elem_type=O.TensorProto.INT64)

    # word lookup: a Gather over the table (host int64 ids are static in a
    # capture; device ids make one capture serve every batch)
    table = g.init("embeddings.word_embeddings.weight",
                   _f32(weights["bert.embeddings.word_embeddings.weight"]))
    h = g.node("Gather", [table, ids], out="/word_emb", axis=0)
    pos = _f32(weights["bert.embeddings.position_embeddings.weight"])[:seq_len]
    pos = pos + _f32(
        weights["bert.embeddings.token_type_embeddings.weight"])[0][None, :]
    padd = g.init("embeddings.position_plus_type", pos)
    h = g.node("Add", [h, padd], out="/emb_sum")
    h = e.layernorm(h, "bert.embeddings.LayerNorm", "embeddings.ln")

    for i in range(int(cfg["num_hidden_layers"])):
        h = _bert_encoder_layer(e, h, f"bert.encoder.layer.{i}",
                                f"encoder.layer.{i}", heads, hidden // heads)

    # pooler: first token -> dense -> Tanh; then the classifier head
    i0 = g.const(np.array(0, dtype=np.int64), "idx0")
    first = g.node("Gather", [h, i0], out="/first_token", axis=1)
    pooled = e.linear2d(first, "bert.pooler.dense", "pooler.dense")
    pooled = g.node("Tanh", [pooled], out="/pooled")
    logits = e.linear2d(pooled, "classifier", "classifier")
    g.node("Identity", [logits], out="logits", name="out_identity")
    g.output("logits", [batch_size, int(cfg["num_labels"])])
    return g.model()


def random_bert_weights(config: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """A BertForSequenceClassification state dict drawn like HF's init:
    normal(0, ``initializer_range``) for the embeddings and every Linear
    weight, zero biases, LayerNorm weights 1 and biases 0."""
    cfg = dict(BERT_BASE, **config)
    rng = np.random.default_rng(seed)
    std = np.float32(cfg["initializer_range"])
    hid, inter = int(cfg["hidden_size"]), int(cfg["intermediate_size"])

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * std

    w = {}

    def linear(key, n_out, n_in):
        w[f"{key}.weight"] = normal(n_out, n_in)
        w[f"{key}.bias"] = np.zeros(n_out, np.float32)

    def layernorm(key):
        w[f"{key}.weight"] = np.ones(hid, np.float32)
        w[f"{key}.bias"] = np.zeros(hid, np.float32)

    emb = "bert.embeddings"
    w[f"{emb}.word_embeddings.weight"] = normal(int(cfg["vocab_size"]), hid)
    w[f"{emb}.position_embeddings.weight"] = normal(
        int(cfg["max_position_embeddings"]), hid)
    w[f"{emb}.token_type_embeddings.weight"] = normal(
        int(cfg["type_vocab_size"]), hid)
    layernorm(f"{emb}.LayerNorm")
    for i in range(int(cfg["num_hidden_layers"])):
        key = f"bert.encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            linear(f"{key}.attention.self.{proj}", hid, hid)
        linear(f"{key}.attention.output.dense", hid, hid)
        layernorm(f"{key}.attention.output.LayerNorm")
        linear(f"{key}.intermediate.dense", inter, hid)
        linear(f"{key}.output.dense", hid, inter)
        layernorm(f"{key}.output.LayerNorm")
    linear("bert.pooler.dense", hid, hid)
    linear("classifier", int(cfg["num_labels"]), hid)
    return w
