"""T5 encoder-decoder ONNX graphs (relative position bias, unscaled
attention, T5LayerNorm, tied and rescaled LM head), built from numpy
weights.

Port of ``numpy_quant_tpu/models/t5.py::t5_encoder`` and
``t5_conditional_generation``: the same nodes, value names, attributes,
inputs and outputs, emitted from a state dict in HuggingFace's
``T5ForConditionalGeneration`` key names
(``encoder.block.{i}.layer.0.SelfAttention.q.weight``, ...) instead of a
live ``transformers`` module:

* T5LayerNorm       -> the RMSNorm nodes of models/llama.py
* attention         -> bias-free q/k/v/o MatMuls, no score scaling (T5 folds
                       it into the init), scores + relative position bias ->
                       Softmax -> context
* relative bias     -> one [1, H, N, N] initializer per stack at the graph's
                       fixed lengths, from block 0's bucket table (every
                       block adds it); the decoder's adds finfo(f32).min
                       above the diagonal (HF's combined bias + causal
                       mask), cross-attention has none
* feed-forward      -> wo(Relu(wi(x))), or the gated-GELU variant (tanh
                       approximation) wo(gelu(wi_0(x)) * wi_1(x))
* LM head           -> MatMul with lm_head^T, after Mul(d_model ** -0.5)
                       when the embeddings are tied

The graphs take float ``inputs_embeds`` [B, S, d_model] (and
``decoder_inputs_embeds`` [B, T, d_model]); the token embedding is a host
gather from ``_wte``, which rides on the returned proto.

``t5_decode_step`` is the KV-cache decode form of the decoder (one token
per call against fixed-length caches, the relative bias entering per step
as the ``score_bias`` input, cross-attention over an ``encoder_memory``
input), node for node with its JAX namesake; its ``[L, H, L+1]`` bias table
rides on the proto as ``_decode_bias``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import onnx as O
from ..onnx.builder import GraphBuilder
from .llama import _matmul_w, _rms_norm
from .vit import _f32

# t5-small (huggingface.co/google-t5/t5-small/config.json)
T5_SMALL = {
    "vocab_size": 32128, "d_model": 512, "d_kv": 64, "d_ff": 2048,
    "num_layers": 6, "num_decoder_layers": 6, "num_heads": 8,
    "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
    "feed_forward_proj": "relu", "tie_word_embeddings": True,
    "initializer_factor": 1.0,
}
_FF = ("relu", "gated-gelu")


def _cfg(config: dict) -> dict:
    cfg = dict(T5_SMALL, **config)
    if "num_decoder_layers" not in config:
        cfg["num_decoder_layers"] = cfg["num_layers"]
    if cfg["feed_forward_proj"] not in _FF:
        raise ValueError(f"feed_forward_proj {cfg['feed_forward_proj']!r} "
                         f"is not built (one of {_FF})")
    return cfg


def _relative_position_bucket(relative_position: torch.Tensor,
                              bidirectional: bool, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """HF ``T5Attention._relative_position_bucket``, step for step: the
    log buckets take ``log`` in float32 and truncate."""
    relative_buckets = 0
    if bidirectional:
        num_buckets //= 2
        relative_buckets += (relative_position > 0).to(torch.long) * num_buckets
        relative_position = torch.abs(relative_position)
    else:
        relative_position = -torch.min(relative_position,
                                       torch.zeros_like(relative_position))
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    if_large = max_exact + (
        torch.log(relative_position.float() / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.long)
    if_large = torch.min(if_large, torch.full_like(if_large, num_buckets - 1))
    return relative_buckets + torch.where(is_small, relative_position,
                                          if_large)


def relative_position_bias(table: np.ndarray, config: dict, q_len: int,
                           k_len: int, bidirectional: bool) -> np.ndarray:
    """The relative position bias [1, H, q_len, k_len] float32 that HF's
    ``T5Attention.compute_bias`` gathers from the bucket table ``table``
    [num_buckets, H] (``...SelfAttention.relative_attention_bias.weight``
    of a stack's block 0), computed on the host with the same torch
    operations; ``bidirectional`` for the encoder, not for the decoder."""
    cfg = _cfg(config)
    with torch.no_grad():
        context = torch.arange(q_len, dtype=torch.long)[:, None]
        memory = torch.arange(k_len, dtype=torch.long)[None, :]
        bucket = _relative_position_bucket(
            memory - context, bidirectional,
            int(cfg["relative_attention_num_buckets"]),
            int(cfg["relative_attention_max_distance"]))
        values = torch.from_numpy(_f32(table))[bucket]  # [q, k, H]
        return values.permute(2, 0, 1).unsqueeze(0).numpy().astype(np.float32)


def _t5_attention(g: GraphBuilder, w: dict, x: str, kv: str, cfg: dict,
                  key: str, q_len: int, kv_len: int, bias: str | None,
                  name: str) -> str:
    """T5Attention: bias-free q/k/v/o projections, no score scaling, the
    optional additive position bias, softmax, context, o. ``kv`` is the
    key/value source (cross-attention reads the encoder output and carries
    no bias)."""
    n_heads, d_kv = int(cfg["num_heads"]), int(cfg["d_kv"])
    q = _matmul_w(g, x, w[f"{key}.q.weight"], f"{name}.q")
    k = _matmul_w(g, kv, w[f"{key}.k.weight"], f"{name}.k")
    v = _matmul_w(g, kv, w[f"{key}.v.weight"], f"{name}.v")

    def split_heads(t: str, seq: int, which: str) -> str:
        shape = g.const(np.array([0, seq, n_heads, d_kv], dtype=np.int64),
                        f"t5headshape{seq}")
        r = g.node("Reshape", [t, shape], out=f"{name}/{which}_Reshape")
        return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                      perm=[0, 2, 1, 3])

    qh = split_heads(q, q_len, "q")
    kh = split_heads(k, kv_len, "k")
    vh = split_heads(v, kv_len, "v")
    kt = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
    scores = g.node("MatMul", [qh, kt], out=f"{name}/scores")
    if bias is not None:
        scores = g.node("Add", [scores, bias], out=f"{name}/biased")
    probs = g.node("Softmax", [scores], out=f"{name}/probs", axis=-1)
    ctx = g.node("MatMul", [probs, vh], out=f"{name}/context")
    ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                 perm=[0, 2, 1, 3])
    merge = g.const(np.array([0, q_len, n_heads * d_kv], dtype=np.int64),
                    f"t5merge{q_len}")
    merged = g.node("Reshape", [ctx, merge], out=f"{name}/merged")
    return _matmul_w(g, merged, w[f"{key}.o.weight"], f"{name}.o")


def _t5_ff(g: GraphBuilder, w: dict, x: str, cfg: dict, key: str,
           name: str) -> str:
    """T5LayerFF body: wo(relu(wi(x))), or the gated variant
    wo(gelu_new(wi_0(x)) * wi_1(x)) with the tanh-approximate GELU."""
    dense = f"{key}.DenseReluDense"
    if cfg["feed_forward_proj"] == "relu":
        h = _matmul_w(g, x, w[f"{dense}.wi.weight"], f"{name}.wi")
        h = g.node("Relu", [h], out=f"{name}/act")
    else:
        h0 = _matmul_w(g, x, w[f"{dense}.wi_0.weight"], f"{name}.wi_0")
        c0 = g.const(np.array(np.float32(np.sqrt(2.0 / np.pi)),
                              dtype=np.float32), "gelu_c0")
        c1 = g.const(np.array(np.float32(0.044715), dtype=np.float32),
                     "gelu_c1")
        half = g.const(np.array(np.float32(0.5), dtype=np.float32),
                       "gelu_half")
        one = g.const(np.array(np.float32(1.0), dtype=np.float32),
                      "gelu_one")
        cube = g.node("Mul", [h0, h0], out=f"{name}/sq")
        cube = g.node("Mul", [cube, h0], out=f"{name}/cube")
        inner = g.node("Mul", [cube, c1], out=f"{name}/cube_c")
        inner = g.node("Add", [h0, inner], out=f"{name}/inner")
        inner = g.node("Mul", [inner, c0], out=f"{name}/scaled")
        t = g.node("Tanh", [inner], out=f"{name}/tanh")
        t = g.node("Add", [t, one], out=f"{name}/tanh1")
        h = g.node("Mul", [h0, t], out=f"{name}/gelu_x")
        h = g.node("Mul", [h, half], out=f"{name}/gelu")
        h1 = _matmul_w(g, x, w[f"{dense}.wi_1.weight"], f"{name}.wi_1")
        h = g.node("Mul", [h, h1], out=f"{name}/gated")
    return _matmul_w(g, h, w[f"{dense}.wo.weight"], f"{name}.wo")


def _encoder(g: GraphBuilder, w: dict, cfg: dict, h: str, src_len: int) -> str:
    """The encoder stack over ``h``; returns its final-normed output. The
    block-0 relative bias is one initializer every block adds."""
    eps = float(cfg["layer_norm_epsilon"])
    ebias = g.init("encoder.rel_bias", relative_position_bias(
        w["encoder.block.0.layer.0.SelfAttention.relative_attention_bias."
          "weight"], cfg, src_len, src_len, bidirectional=True))
    for i in range(int(cfg["num_layers"])):
        key, name = f"encoder.block.{i}", f"encoder.block.{i}"
        ln = _rms_norm(g, h, w[f"{key}.layer.0.layer_norm.weight"], eps,
                       f"{name}.ln0")
        att = _t5_attention(g, w, ln, ln, cfg, f"{key}.layer.0.SelfAttention",
                            src_len, src_len, ebias, f"{name}.attn")
        h = g.node("Add", [h, att], out=f"{name}/residual0")
        ln = _rms_norm(g, h, w[f"{key}.layer.1.layer_norm.weight"], eps,
                       f"{name}.ln1")
        ff = _t5_ff(g, w, ln, cfg, f"{key}.layer.1", f"{name}.ff")
        h = g.node("Add", [h, ff], out=f"{name}/residual1")
    return _rms_norm(g, h, w["encoder.final_layer_norm.weight"], eps,
                     "encoder.final_norm")


def t5_encoder(weights: dict, config: dict, batch_size: int = 2,
               seq_len: int = 12) -> O.ModelProto:
    """T5 encoder stack over float ``inputs_embeds`` [B, N, d_model] ->
    ``hidden`` [B, N, d_model]."""
    cfg = _cfg(config)
    g = GraphBuilder("t5_encoder")
    d_model = int(cfg["d_model"])
    h = g.input("inputs_embeds", [batch_size, seq_len, d_model])
    h = _encoder(g, weights, cfg, h, seq_len)
    g.node("Identity", [h], out="hidden", name="hidden_id")
    g.output("hidden", [batch_size, seq_len, d_model])
    model = g.model()
    model._wte = _f32(weights["shared.weight"])  # [vocab, d_model]
    return model


def _t5_lm_head(g: GraphBuilder, w: dict, cfg: dict, h: str) -> None:
    """The LM head into ``logits``: MatMul with lm_head^T, after
    Mul(d_model ** -0.5) when the embeddings are tied (HF rescales tied
    logits)."""
    if cfg["tie_word_embeddings"]:
        sc = g.const(np.array(np.float32(int(cfg["d_model"]) ** -0.5),
                              dtype=np.float32), "logit_scale")
        h = g.node("Mul", [h, sc], out="logits_scaled")
    head = w["shared.weight"] if cfg["tie_word_embeddings"] \
        else w["lm_head.weight"]
    g.init("lm_head.weight_t", np.ascontiguousarray(_f32(head).T))
    g.node("MatMul", [h, "lm_head.weight_t"], out="logits", name="lm_head")


def t5_conditional_generation(weights: dict, config: dict,
                              batch_size: int = 2, src_len: int = 12,
                              tgt_len: int = 8) -> O.ModelProto:
    """The full T5ForConditionalGeneration forward in one graph:
    ``inputs_embeds`` [B, S, d_model] + ``decoder_inputs_embeds`` [B, T,
    d_model] -> ``logits`` [B, T, vocab] (teacher-forced scoring). Decoder
    self-attention adds the combined constant HF builds (bias + finfo.min
    above the diagonal); cross-attention is bias-free and unscaled."""
    cfg = _cfg(config)
    w = weights
    eps = float(cfg["layer_norm_epsilon"])
    d_model = int(cfg["d_model"])
    g = GraphBuilder("t5_conditional_generation")
    h = g.input("inputs_embeds", [batch_size, src_len, d_model])
    hd = g.input("decoder_inputs_embeds", [batch_size, tgt_len, d_model])
    h = _encoder(g, w, cfg, h, src_len)

    dbias = relative_position_bias(
        w["decoder.block.0.layer.0.SelfAttention.relative_attention_bias."
          "weight"], cfg, tgt_len, tgt_len, bidirectional=False)
    mask = np.triu(np.full((tgt_len, tgt_len), np.finfo(np.float32).min,
                           dtype=np.float32), k=1)
    dbias = g.init("decoder.rel_bias_masked", dbias + mask[None, None])
    for i in range(int(cfg["num_decoder_layers"])):
        key, name = f"decoder.block.{i}", f"decoder.block.{i}"
        ln = _rms_norm(g, hd, w[f"{key}.layer.0.layer_norm.weight"], eps,
                       f"{name}.ln0")
        att = _t5_attention(g, w, ln, ln, cfg, f"{key}.layer.0.SelfAttention",
                            tgt_len, tgt_len, dbias, f"{name}.self")
        hd = g.node("Add", [hd, att], out=f"{name}/residual0")
        ln = _rms_norm(g, hd, w[f"{key}.layer.1.layer_norm.weight"], eps,
                       f"{name}.ln1")
        att = _t5_attention(g, w, ln, h, cfg, f"{key}.layer.1.EncDecAttention",
                            tgt_len, src_len, None, f"{name}.cross")
        hd = g.node("Add", [hd, att], out=f"{name}/residual1")
        ln = _rms_norm(g, hd, w[f"{key}.layer.2.layer_norm.weight"], eps,
                       f"{name}.ln2")
        ff = _t5_ff(g, w, ln, cfg, f"{key}.layer.2", f"{name}.ff")
        hd = g.node("Add", [hd, ff], out=f"{name}/residual2")
    hd = _rms_norm(g, hd, w["decoder.final_layer_norm.weight"], eps,
                   "decoder.final_norm")

    _t5_lm_head(g, w, cfg, hd)
    g.output("logits", [batch_size, tgt_len, int(cfg["vocab_size"])])
    model = g.model()
    model._wte = _f32(w["shared.weight"])  # [vocab, d_model]
    return model


def decode_bias_table(weights: dict, config: dict,
                      max_len: int) -> np.ndarray:
    """The per-step relative-bias rows of the KV-cache layout,
    ``[max_len, H, max_len + 1]`` float32: row t is the decoder's
    (unidirectional) bias at query position t over key positions
    0..max_len-1, plus a self column (relative distance 0). Future slots
    (j > t) carry the non-causal values; the decode mask adds -1e9 to them
    before the bias, so they never reach Softmax unmasked."""
    full = relative_position_bias(
        weights["decoder.block.0.layer.0.SelfAttention."
                "relative_attention_bias.weight"], config, max_len, max_len,
        bidirectional=False)[0]                          # [H, L, L]
    n_heads = full.shape[0]
    table = np.empty((max_len, n_heads, max_len + 1), np.float32)
    for t in range(max_len):
        table[t, :, :max_len] = full[:, t, :]
        table[t, :, max_len] = full[:, t, t]             # the self column
    return table


def _t5_decode_self_attention(g: GraphBuilder, w: dict, x: str, cfg: dict,
                              key: str, layer: int, max_len: int,
                              name: str) -> tuple[str, str, str]:
    """One-token T5 self-attention against a fixed-length cache: unscaled
    bias-free projections, scores over [cache | current], the additive
    ``attn_mask`` input, then the per-step ``score_bias`` input, Softmax,
    and the probabilities split back into a cache product plus a self
    term. Returns (o output, k_step, v_step)."""
    n_heads, d_kv = int(cfg["num_heads"]), int(cfg["d_kv"])
    q = _matmul_w(g, x, w[f"{key}.q.weight"], f"{name}.q")
    k = _matmul_w(g, x, w[f"{key}.k.weight"], f"{name}.k")
    v = _matmul_w(g, x, w[f"{key}.v.weight"], f"{name}.v")

    def split_heads(t: str, which: str) -> str:
        shape = g.const(np.array([0, 1, n_heads, d_kv], dtype=np.int64),
                        "t5dheadshape")
        r = g.node("Reshape", [t, shape], out=f"{name}/{which}_Reshape")
        return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                      perm=[0, 2, 1, 3])

    qh, kh, vh = split_heads(q, "q"), split_heads(k, "k"), split_heads(v, "v")
    kt_cache = g.node("Transpose", [f"past_k.{layer}"],
                      out=f"{name}/cache_k_T", perm=[0, 1, 3, 2])
    s_past = g.node("MatMul", [qh, kt_cache], out=f"{name}/scores_past")
    kt_step = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
    s_self = g.node("MatMul", [qh, kt_step], out=f"{name}/scores_self")
    s = g.node("Concat", [s_past, s_self], out=f"{name}/scores", axis=-1)
    masked = g.node("Add", [s, "attn_mask"], out=f"{name}/masked")
    biased = g.node("Add", [masked, "score_bias"], out=f"{name}/biased")
    probs = g.node("Softmax", [biased], out=f"{name}/probs", axis=-1)
    z = g.const(np.array([0], dtype=np.int64), "zero")
    ll = g.const(np.array([max_len], dtype=np.int64), "maxlen")
    lp1 = g.const(np.array([max_len + 1], dtype=np.int64), "maxlenp1")
    ax = g.const(np.array([-1], dtype=np.int64), "lastaxis")
    p_past = g.node("Slice", [probs, z, ll, ax], out=f"{name}/p_past")
    p_self = g.node("Slice", [probs, ll, lp1, ax], out=f"{name}/p_self")
    ctx = g.node("MatMul", [p_past, f"past_v.{layer}"],
                 out=f"{name}/ctx_past")
    self_ctx = g.node("Mul", [p_self, vh], out=f"{name}/ctx_self")
    ctx = g.node("Add", [ctx, self_ctx], out=f"{name}/context")
    ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                 perm=[0, 2, 1, 3])
    merge = g.const(np.array([0, 1, n_heads * d_kv], dtype=np.int64),
                    "t5dmergeshape")
    merged = g.node("Reshape", [ctx, merge], out=f"{name}/merged")
    return _matmul_w(g, merged, w[f"{key}.o.weight"], f"{name}.o"), kh, vh


def _t5_decode_cross_attention(g: GraphBuilder, w: dict, x: str, cfg: dict,
                               key: str, memory: str, src_len: int,
                               name: str) -> str:
    """One-token unscaled bias-free cross-attention over the whole encoder
    memory; K and V are projected from the memory inside the step."""
    n_heads, d_kv = int(cfg["num_heads"]), int(cfg["d_kv"])
    q = _matmul_w(g, x, w[f"{key}.q.weight"], f"{name}.q")
    k = _matmul_w(g, memory, w[f"{key}.k.weight"], f"{name}.k")
    v = _matmul_w(g, memory, w[f"{key}.v.weight"], f"{name}.v")

    def split_heads(t: str, seq: int, which: str) -> str:
        shape = g.const(np.array([0, seq, n_heads, d_kv], dtype=np.int64),
                        f"t5xheadshape{seq}")
        r = g.node("Reshape", [t, shape], out=f"{name}/{which}_Reshape")
        return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                      perm=[0, 2, 1, 3])

    qh = split_heads(q, 1, "q")
    kh = split_heads(k, src_len, "k")
    vh = split_heads(v, src_len, "v")
    kt = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
    scores = g.node("MatMul", [qh, kt], out=f"{name}/scores")
    probs = g.node("Softmax", [scores], out=f"{name}/probs", axis=-1)
    ctx = g.node("MatMul", [probs, vh], out=f"{name}/context")
    ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                 perm=[0, 2, 1, 3])
    merge = g.const(np.array([0, 1, n_heads * d_kv], dtype=np.int64),
                    "t5dmergeshape")
    merged = g.node("Reshape", [ctx, merge], out=f"{name}/merged")
    return _matmul_w(g, merged, w[f"{key}.o.weight"], f"{name}.o")


def t5_decode_step(weights: dict, config: dict, batch_size: int = 2,
                   max_len: int = 8, src_len: int = 12) -> O.ModelProto:
    """The KV-cache decode form of the T5 decoder, one token per call.

    Inputs, in order: ``x_step`` [B, 1, d] (the token embedding; T5 has no
    positions, so ``generate_kv`` takes ``wpe=None``), ``attn_mask``
    [1, 1, 1, L+1] additive, ``score_bias`` [1, H, 1, L+1] (row t of the
    ``_decode_bias`` table on the proto, fed by ``generate_kv(...,
    score_bias=proto._decode_bias)``; every layer adds it, as HF shares
    block 0's bias), ``encoder_memory`` [B, S, d], then ``past_k.i``/
    ``past_v.i`` [B, H, L, d_kv] per layer. Outputs: ``logits`` [B, 1, V],
    then ``present_k.i``/``present_v.i`` [B, H, 1, d_kv] per layer."""
    cfg = _cfg(config)
    w = weights
    eps = float(cfg["layer_norm_epsilon"])
    d_model = int(cfg["d_model"])
    n_heads, d_kv = int(cfg["num_heads"]), int(cfg["d_kv"])
    g = GraphBuilder("t5_decode_step")
    h = g.input("x_step", [batch_size, 1, d_model])
    g.input("attn_mask", [1, 1, 1, max_len + 1])
    g.input("score_bias", [1, n_heads, 1, max_len + 1])
    memory = g.input("encoder_memory", [batch_size, src_len, d_model])
    n_layer = int(cfg["num_decoder_layers"])
    for i in range(n_layer):
        g.input(f"past_k.{i}", [batch_size, n_heads, max_len, d_kv])
        g.input(f"past_v.{i}", [batch_size, n_heads, max_len, d_kv])
    presents = []
    for i in range(n_layer):
        key, name = f"decoder.block.{i}", f"decoder.block.{i}"
        ln = _rms_norm(g, h, w[f"{key}.layer.0.layer_norm.weight"], eps,
                       f"{name}.ln0")
        att, kh, vh = _t5_decode_self_attention(
            g, w, ln, cfg, f"{key}.layer.0.SelfAttention", i, max_len,
            f"{name}.self")
        presents.append((kh, vh))
        h = g.node("Add", [h, att], out=f"{name}/residual0")
        ln = _rms_norm(g, h, w[f"{key}.layer.1.layer_norm.weight"], eps,
                       f"{name}.ln1")
        att = _t5_decode_cross_attention(
            g, w, ln, cfg, f"{key}.layer.1.EncDecAttention", memory, src_len,
            f"{name}.cross")
        h = g.node("Add", [h, att], out=f"{name}/residual1")
        ln = _rms_norm(g, h, w[f"{key}.layer.2.layer_norm.weight"], eps,
                       f"{name}.ln2")
        ff = _t5_ff(g, w, ln, cfg, f"{key}.layer.2", f"{name}.ff")
        h = g.node("Add", [h, ff], out=f"{name}/residual2")
    h = _rms_norm(g, h, w["decoder.final_layer_norm.weight"], eps,
                  "decoder.final_norm")
    _t5_lm_head(g, w, cfg, h)
    g.output("logits", [batch_size, 1, int(cfg["vocab_size"])])
    for i, (kh, vh) in enumerate(presents):
        g.node("Identity", [kh], out=f"present_k.{i}",
               name=f"present_k_id.{i}")
        g.node("Identity", [vh], out=f"present_v.{i}",
               name=f"present_v_id.{i}")
        g.output(f"present_k.{i}", [batch_size, n_heads, 1, d_kv])
        g.output(f"present_v.{i}", [batch_size, n_heads, 1, d_kv])
    model = g.model()
    model._wte = _f32(w["shared.weight"])  # [vocab, d_model]
    model._decode_bias = decode_bias_table(w, cfg, max_len)
    return model


def random_t5_weights(config: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """A T5ForConditionalGeneration state dict drawn as HF's
    ``T5PreTrainedModel._init_weights`` draws it: normal(0, f) for the
    shared embedding (and an untied LM head), q normal(0, f (d_model
    d_kv)^-1/2), k and v normal(0, f d_model^-1/2), o normal(0, f (H
    d_kv)^-1/2), the relative bias tables normal(0, f d_model^-1/2), wi
    (wi_0, wi_1) normal(0, f d_model^-1/2), wo normal(0, f d_ff^-1/2), layer
    norms 1 (f = ``initializer_factor``). The tied copies
    (``encoder/decoder.embed_tokens.weight``, a tied ``lm_head.weight``)
    are the shared array."""
    cfg = _cfg(config)
    rng = np.random.default_rng(seed)
    f = float(cfg["initializer_factor"])
    d_model, d_kv, d_ff = (int(cfg[k]) for k in ("d_model", "d_kv", "d_ff"))
    n_heads = int(cfg["num_heads"])
    inner = n_heads * d_kv

    def normal(std, *shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    shared = normal(f, int(cfg["vocab_size"]), d_model)
    w = {"shared.weight": shared, "encoder.embed_tokens.weight": shared,
         "decoder.embed_tokens.weight": shared,
         "lm_head.weight": shared if cfg["tie_word_embeddings"]
         else normal(f, int(cfg["vocab_size"]), d_model)}

    def attention(key, relative):
        w[f"{key}.q.weight"] = normal(f * (d_model * d_kv) ** -0.5, inner,
                                      d_model)
        w[f"{key}.k.weight"] = normal(f * d_model ** -0.5, inner, d_model)
        w[f"{key}.v.weight"] = normal(f * d_model ** -0.5, inner, d_model)
        w[f"{key}.o.weight"] = normal(f * inner ** -0.5, d_model, inner)
        if relative:
            w[f"{key}.relative_attention_bias.weight"] = normal(
                f * d_model ** -0.5,
                int(cfg["relative_attention_num_buckets"]), n_heads)

    def ff(key):
        dense = f"{key}.DenseReluDense"
        names = ("wi",) if cfg["feed_forward_proj"] == "relu" \
            else ("wi_0", "wi_1")
        for name in names:
            w[f"{dense}.{name}.weight"] = normal(f * d_model ** -0.5, d_ff,
                                                 d_model)
        w[f"{dense}.wo.weight"] = normal(f * d_ff ** -0.5, d_model, d_ff)
        w[f"{key}.layer_norm.weight"] = np.ones(d_model, np.float32)

    for i in range(int(cfg["num_layers"])):
        key = f"encoder.block.{i}"
        attention(f"{key}.layer.0.SelfAttention", i == 0)
        w[f"{key}.layer.0.layer_norm.weight"] = np.ones(d_model, np.float32)
        ff(f"{key}.layer.1")
    w["encoder.final_layer_norm.weight"] = np.ones(d_model, np.float32)
    for i in range(int(cfg["num_decoder_layers"])):
        key = f"decoder.block.{i}"
        attention(f"{key}.layer.0.SelfAttention", i == 0)
        w[f"{key}.layer.0.layer_norm.weight"] = np.ones(d_model, np.float32)
        attention(f"{key}.layer.1.EncDecAttention", False)
        w[f"{key}.layer.1.layer_norm.weight"] = np.ones(d_model, np.float32)
        ff(f"{key}.layer.2")
    w["decoder.final_layer_norm.weight"] = np.ones(d_model, np.float32)
    return w
