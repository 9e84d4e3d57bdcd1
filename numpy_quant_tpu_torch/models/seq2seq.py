"""BART-style encoder-decoder ONNX graphs (post-LN blocks, learned positions
at BART's +2 offset, layernorm_embedding, exact-erf GELU, tied LM head),
built from numpy weights.

Port of ``numpy_quant_tpu/models/seq2seq.py``: ``bart_seq2seq``,
``bart_encoder``, ``bart_decoder`` and ``bart_decode_step`` emit the same
nodes, value names, attributes, inputs and outputs as their JAX namesakes,
from a state dict in HuggingFace's ``BartForConditionalGeneration`` key
names (``model.encoder.layers.{i}.self_attn.q_proj.weight``, ...) instead
of a live ``transformers`` module:

* attention       -> q/k/v Linears, scores -> Mul(1/sqrt(d)) -> [Add(causal
                     initializer)] -> Softmax, with the Concat(batch dim,
                     [-1, H, D]) head-split Reshape chains; the decode step
                     pre-scales q (HF's order) and splits heads by constant
                     shapes
* positions       -> the learned table's rows from BART's offset 2, baked at
                     the graph's length, then layernorm_embedding
* LM head         -> MatMul with the shared embedding^T (tied;
                     final_logits_bias, zeros in HF, is left out)

The graphs take float embeddings; the token embedding is a gather from
``_wte`` outside, and ``_enc_pos``/``_dec_pos`` (the position tables past
the offset) ride on the proto. ``generate_seq2seq`` runs the encoder once
and the decoder per token; ``generate_kv(..., memory=)`` drives the decode
step with ``wpe=proto._dec_pos``.
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder
from .vit import _ViTEmitter, _f32

# facebook/bart-base (huggingface.co/facebook/bart-base/config.json)
BART_BASE = {
    "vocab_size": 50265, "d_model": 768, "encoder_layers": 6,
    "decoder_layers": 6, "encoder_attention_heads": 12,
    "decoder_attention_heads": 12, "encoder_ffn_dim": 3072,
    "decoder_ffn_dim": 3072, "max_position_embeddings": 1024,
    "activation_function": "gelu", "scale_embedding": False,
    "init_std": 0.02, "pad_token_id": 1, "decoder_start_token_id": 2,
}
_POS_OFFSET = 2  # BartLearnedPositionalEmbedding's offset
_LN_EPS = 1e-5   # torch.nn.LayerNorm's default


def _cfg(config: dict) -> dict:
    cfg = dict(BART_BASE, **config)
    if cfg["activation_function"] != "gelu":
        raise ValueError("the BART graphs emit the exact-erf GELU; "
                         f"activation_function {cfg['activation_function']!r} "
                         "is not built")
    if cfg["scale_embedding"]:
        raise ValueError("scale_embedding is not built: the embeddings "
                         "enter the graphs unscaled")
    return cfg


def _bart_attention(e: _ViTEmitter, q_src: str, kv_src: str, key: str,
                    n_heads: int, name: str,
                    causal_len: int | None = None) -> str:
    """BartAttention: q/k/v Linears, the post-scores Mul(1/sqrt(d)), the
    optional additive causal initializer, softmax, context, out_proj.
    ``q_src`` and ``kv_src`` differ for cross-attention."""
    g = e.g
    head_size = e.w[f"{key}.q_proj.weight"].shape[0] // n_heads
    q = e.linear3d(q_src, f"{key}.q_proj", f"{name}.q_proj")
    k = e.linear3d(kv_src, f"{key}.k_proj", f"{name}.k_proj")
    v = e.linear3d(kv_src, f"{key}.v_proj", f"{name}.v_proj")
    b_dim = e.batch_dim(q_src, f"{name}/bdim")
    tail = g.const(np.array([-1, n_heads, head_size], dtype=np.int64),
                   "headshape")
    new_shape = g.node("Concat", [b_dim, tail], out=f"{name}/Concat_shape",
                       axis=0)

    def split_heads(t: str, which: str) -> str:
        r = g.node("Reshape", [t, new_shape], out=f"{name}/{which}_Reshape")
        return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                      perm=[0, 2, 1, 3])

    qh, kh, vh = split_heads(q, "q"), split_heads(k, "k"), split_heads(v, "v")
    kt = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
    scores = g.node("MatMul", [qh, kt], out=f"{name}/scores")
    scal = g.const(np.array(np.float32(1.0 / np.sqrt(head_size)),
                            dtype=np.float32), "scaling")
    h = g.node("Mul", [scores, scal], out=f"{name}/scaled")
    if causal_len is not None:
        mask = np.triu(np.full((causal_len, causal_len), np.float32(-1e9)),
                       k=1)[None, None].astype(np.float32)
        mc = g.init(f"{name}.causal_mask", mask)
        h = g.node("Add", [h, mc], out=f"{name}/masked")
    probs = g.node("Softmax", [h], out=f"{name}/probs", axis=-1)
    ctx = g.node("MatMul", [probs, vh], out=f"{name}/context")
    ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                 perm=[0, 2, 1, 3])
    merge_tail = g.const(np.array([-1, n_heads * head_size], dtype=np.int64),
                         "mergeshape")
    merge_shape = g.node("Concat", [b_dim, merge_tail],
                         out=f"{name}/Concat_merge", axis=0)
    merged = g.node("Reshape", [ctx, merge_shape], out=f"{name}/merged")
    return e.linear3d(merged, f"{key}.out_proj", f"{name}.out_proj")


def _ffn(e: _ViTEmitter, x: str, key: str, name: str) -> str:
    fc = e.linear3d(x, f"{key}.fc1", f"{name}.fc1")
    act = e.gelu(fc, f"{name}.gelu")
    return e.linear3d(act, f"{key}.fc2", f"{name}.fc2")


def _encoder_layer(e: _ViTEmitter, x: str, key: str, n_heads: int,
                   name: str) -> str:
    """BartEncoderLayer (post-LN): LayerNorm after each residual add."""
    g = e.g
    att = _bart_attention(e, x, x, f"{key}.self_attn", n_heads,
                          f"{name}.self_attn")
    x = g.node("Add", [att, x], out=f"{name}/residual1")
    x = e.layernorm(x, f"{key}.self_attn_layer_norm", f"{name}.self_attn_ln")
    f = _ffn(e, x, key, name)
    x = g.node("Add", [f, x], out=f"{name}/residual2")
    return e.layernorm(x, f"{key}.final_layer_norm", f"{name}.final_ln")


def _decoder_layer(e: _ViTEmitter, x: str, memory: str, key: str,
                   n_heads: int, tgt_len: int, name: str) -> str:
    """BartDecoderLayer: causal self-attention, cross-attention over the
    encoder memory (q from the decoder stream, k/v from ``memory``), FFN;
    post-LN."""
    g = e.g
    att = _bart_attention(e, x, x, f"{key}.self_attn", n_heads,
                          f"{name}.self_attn", causal_len=tgt_len)
    x = g.node("Add", [att, x], out=f"{name}/residual1")
    x = e.layernorm(x, f"{key}.self_attn_layer_norm", f"{name}.self_attn_ln")
    xa = _bart_attention(e, x, memory, f"{key}.encoder_attn", n_heads,
                         f"{name}.encoder_attn")
    x = g.node("Add", [xa, x], out=f"{name}/residual2")
    x = e.layernorm(x, f"{key}.encoder_attn_layer_norm",
                    f"{name}.encoder_attn_ln")
    f = _ffn(e, x, key, name)
    x = g.node("Add", [f, x], out=f"{name}/residual3")
    return e.layernorm(x, f"{key}.final_layer_norm", f"{name}.final_ln")


def _embed(e: _ViTEmitter, x: str, stack: str, length: int,
           name: str) -> str:
    """embeds + learned positions (BART's +2 table offset) ->
    layernorm_embedding."""
    g = e.g
    table = _f32(e.w[f"{stack}.embed_positions.weight"])
    pos = g.init(f"{name}.pos.slice",
                 table[_POS_OFFSET:_POS_OFFSET + length])
    h = g.node("Add", [x, pos], out=f"{name}/pos_add")
    return e.layernorm(h, f"{stack}.layernorm_embedding", f"{name}.ln_embed")


def _emit_encoder(e: _ViTEmitter, cfg: dict, x: str, src_len: int) -> str:
    h = _embed(e, x, "model.encoder", src_len, "encoder")
    for i in range(int(cfg["encoder_layers"])):
        h = _encoder_layer(e, h, f"model.encoder.layers.{i}",
                           int(cfg["encoder_attention_heads"]),
                           f"encoder.{i}")
    return h


def _lm_head(e: _ViTEmitter, h: str) -> None:
    """The tied LM head: logits = h @ shared^T."""
    head = e.g.init("lm_head.weight_t", np.ascontiguousarray(
        _f32(e.w["model.shared.weight"]).T))
    e.g.node("MatMul", [h, head], out="logits", name="lm_head")


def _emit_decoder(e: _ViTEmitter, cfg: dict, x: str, memory: str,
                  tgt_len: int) -> str:
    h = _embed(e, x, "model.decoder", tgt_len, "decoder")
    for i in range(int(cfg["decoder_layers"])):
        h = _decoder_layer(e, h, memory, f"model.decoder.layers.{i}",
                           int(cfg["decoder_attention_heads"]), tgt_len,
                           f"decoder.{i}")
    _lm_head(e, h)
    return "logits"


def _finish(g: GraphBuilder, weights: dict) -> O.ModelProto:
    """The proto with the host tables that ride on it: ``_wte`` [vocab, d],
    and ``_enc_pos``/``_dec_pos`` [n_pos, d], the position tables past
    BART's offset."""
    model = g.model()
    model._wte = _f32(weights["model.shared.weight"])
    model._enc_pos = _f32(
        weights["model.encoder.embed_positions.weight"])[_POS_OFFSET:]
    model._dec_pos = _f32(
        weights["model.decoder.embed_positions.weight"])[_POS_OFFSET:]
    return model


def bart_seq2seq(weights: dict, config: dict, batch_size: int = 2,
                 src_len: int = 12, tgt_len: int = 8) -> O.ModelProto:
    """The full encoder + decoder graph: ``encoder_embeds`` [B, S, d] +
    ``decoder_embeds`` [B, T, d] -> ``logits`` [B, T, V]."""
    cfg = _cfg(config)
    d = int(cfg["d_model"])
    g = GraphBuilder("bart_seq2seq")
    e = _ViTEmitter(g, weights, _LN_EPS)
    xe = g.input("encoder_embeds", [batch_size, src_len, d])
    xd = g.input("decoder_embeds", [batch_size, tgt_len, d])
    memory = _emit_encoder(e, cfg, xe, src_len)
    _emit_decoder(e, cfg, xd, memory, tgt_len)
    g.output("logits", [batch_size, tgt_len, int(cfg["vocab_size"])])
    return _finish(g, weights)


def bart_encoder(weights: dict, config: dict, batch_size: int = 2,
                 src_len: int = 12) -> O.ModelProto:
    """The encoder alone: ``encoder_embeds`` [B, S, d] -> ``encoder_memory``
    [B, S, d], run once per sequence."""
    cfg = _cfg(config)
    d = int(cfg["d_model"])
    g = GraphBuilder("bart_encoder")
    e = _ViTEmitter(g, weights, _LN_EPS)
    x = g.input("encoder_embeds", [batch_size, src_len, d])
    memory = _emit_encoder(e, cfg, x, src_len)
    g.node("Identity", [memory], out="encoder_memory", name="memory_id")
    g.output("encoder_memory", [batch_size, src_len, d])
    return _finish(g, weights)


def bart_decoder(weights: dict, config: dict, batch_size: int = 2,
                 src_len: int = 12, tgt_len: int = 8) -> O.ModelProto:
    """The decoder alone: ``decoder_embeds`` [B, T, d] + ``encoder_memory``
    [B, S, d] -> ``logits`` [B, T, V], run once per token against the
    encoder's memory."""
    cfg = _cfg(config)
    d = int(cfg["d_model"])
    g = GraphBuilder("bart_decoder")
    e = _ViTEmitter(g, weights, _LN_EPS)
    xd = g.input("decoder_embeds", [batch_size, tgt_len, d])
    memory = g.input("encoder_memory", [batch_size, src_len, d])
    _emit_decoder(e, cfg, xd, memory, tgt_len)
    g.output("logits", [batch_size, tgt_len, int(cfg["vocab_size"])])
    return _finish(g, weights)


def _split_step_heads(g: GraphBuilder, t: str, seq: int, n_heads: int,
                      head_size: int, hint: str, name: str,
                      which: str) -> str:
    """Reshape [B, seq, H*D] by a constant [0, seq, H, D] and transpose to
    [B, H, seq, D]."""
    shape = g.const(np.array([0, seq, n_heads, head_size], dtype=np.int64),
                    hint)
    r = g.node("Reshape", [t, shape], out=f"{name}/{which}_Reshape")
    return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                  perm=[0, 2, 1, 3])


def _scaled_q(e: _ViTEmitter, x: str, key: str, head_size: int,
              scale_hint: str, name: str) -> str:
    """q_proj(x) * head_size ** -0.5 (HF's pre-scaled q)."""
    g = e.g
    q = e.linear3d(x, f"{key}.q_proj", f"{name}.q_proj")
    scal = g.const(np.array(np.float32(head_size ** -0.5), dtype=np.float32),
                   scale_hint)
    return g.node("Mul", [q, scal], out=f"{name}/q_scaled")


def _decode_self_attention(e: _ViTEmitter, q: str, k: str, v: str,
                           layer: int, n_heads: int, head_size: int,
                           max_len: int, hints: tuple,
                           name: str) -> tuple[str, str, str]:
    """One-token self-attention against a fixed-length cache from the
    projected (pre-scaled) q, k and v: scores over [cache | current], the
    additive ``attn_mask`` input, Softmax, the probabilities split back
    into a cache product plus a self term, out_proj. ``hints`` are the
    head-shape and merge-shape constant names. Returns (merged context,
    k_step, v_step)."""
    g = e.g
    head_hint, merge_hint = hints
    qh, kh, vh = (_split_step_heads(g, t, 1, n_heads, head_size, head_hint,
                                    name, which)
                  for t, which in ((q, "q"), (k, "k"), (v, "v")))
    kt_cache = g.node("Transpose", [f"past_k.{layer}"],
                      out=f"{name}/cache_k_T", perm=[0, 1, 3, 2])
    s_past = g.node("MatMul", [qh, kt_cache], out=f"{name}/scores_past")
    kt_step = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
    s_self = g.node("MatMul", [qh, kt_step], out=f"{name}/scores_self")
    s = g.node("Concat", [s_past, s_self], out=f"{name}/scores", axis=-1)
    masked = g.node("Add", [s, "attn_mask"], out=f"{name}/masked")
    probs = g.node("Softmax", [masked], out=f"{name}/probs", axis=-1)
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
    merge = g.const(np.array([0, 1, n_heads * head_size], dtype=np.int64),
                    merge_hint)
    return g.node("Reshape", [ctx, merge], out=f"{name}/merged"), kh, vh


def _decode_cross_attention(e: _ViTEmitter, q: str, k: str, v: str,
                            n_heads: int, head_size: int, src_len: int,
                            hints: tuple, name: str) -> str:
    """One-token cross-attention of the pre-scaled q over the whole encoder
    memory's projected k and v; returns the merged context."""
    g = e.g
    head_hint, merge_hint = hints
    qh = _split_step_heads(g, q, 1, n_heads, head_size,
                           f"{head_hint}1", name, "q")
    kh = _split_step_heads(g, k, src_len, n_heads, head_size,
                           f"{head_hint}{src_len}", name, "k")
    vh = _split_step_heads(g, v, src_len, n_heads, head_size,
                           f"{head_hint}{src_len}", name, "v")
    kt = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
    scores = g.node("MatMul", [qh, kt], out=f"{name}/scores")
    probs = g.node("Softmax", [scores], out=f"{name}/probs", axis=-1)
    ctx = g.node("MatMul", [probs, vh], out=f"{name}/context")
    ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                 perm=[0, 2, 1, 3])
    merge = g.const(np.array([0, 1, n_heads * head_size], dtype=np.int64),
                    merge_hint)
    return g.node("Reshape", [ctx, merge], out=f"{name}/merged")


def _step_outputs(g: GraphBuilder, presents: list, batch_size: int,
                  n_heads: int, head_size: int, vocab: int) -> None:
    """``logits`` [B, 1, V], then ``present_k.i``/``present_v.i``
    [B, H, 1, D] per layer, one Identity each."""
    g.output("logits", [batch_size, 1, vocab])
    for i, (kh, vh) in enumerate(presents):
        g.node("Identity", [kh], out=f"present_k.{i}",
               name=f"present_k_id.{i}")
        g.node("Identity", [vh], out=f"present_v.{i}",
               name=f"present_v_id.{i}")
        g.output(f"present_k.{i}", [batch_size, n_heads, 1, head_size])
        g.output(f"present_v.{i}", [batch_size, n_heads, 1, head_size])


def _step_inputs(g: GraphBuilder, batch_size: int, d: int, max_len: int,
                 src_len: int, n_layer: int, n_heads: int,
                 head_size: int) -> tuple[str, str]:
    """The decode step's inputs: x_step [B, 1, d], attn_mask [1, 1, 1, L+1],
    encoder_memory [B, S, d], then past_k.i/past_v.i [B, H, L, D]."""
    h = g.input("x_step", [batch_size, 1, d])
    g.input("attn_mask", [1, 1, 1, max_len + 1])
    memory = g.input("encoder_memory", [batch_size, src_len, d])
    for i in range(n_layer):
        g.input(f"past_k.{i}", [batch_size, n_heads, max_len, head_size])
        g.input(f"past_v.{i}", [batch_size, n_heads, max_len, head_size])
    return h, memory


def bart_decode_step(weights: dict, config: dict, batch_size: int = 2,
                     max_len: int = 8, src_len: int = 12) -> O.ModelProto:
    """The KV-cache decode form of the BART decoder, one token per call.

    Inputs, in order: ``x_step`` [B, 1, d] (token embedding + learned
    position, added by ``generate_kv`` with ``wpe=proto._dec_pos``),
    ``attn_mask`` [1, 1, 1, L+1] additive, ``encoder_memory`` [B, S, d]
    (the encoder's output, fed by ``generate_kv(..., memory=)``), then
    ``past_k.i``/``past_v.i`` [B, H, L, D] per layer. Outputs: ``logits``
    [B, 1, V], then ``present_k.i``/``present_v.i`` [B, H, 1, D] per layer.
    The graph opens with layernorm_embedding, which BART applies to
    embeddings plus positions."""
    cfg = _cfg(config)
    d = int(cfg["d_model"])
    n_heads = int(cfg["decoder_attention_heads"])
    head_size = d // n_heads
    n_layer = int(cfg["decoder_layers"])
    g = GraphBuilder("bart_decode_step")
    e = _ViTEmitter(g, weights, _LN_EPS)
    h, memory = _step_inputs(g, batch_size, d, max_len, src_len, n_layer,
                             n_heads, head_size)
    h = e.layernorm(h, "model.decoder.layernorm_embedding",
                    "decoder.ln_embed")
    presents = []
    for i in range(n_layer):
        key, name = f"model.decoder.layers.{i}", f"decoder.{i}"
        sa, sname = f"{key}.self_attn", f"{name}.self_attn"
        q = _scaled_q(e, h, sa, head_size, "bscaling", sname)
        k = e.linear3d(h, f"{sa}.k_proj", f"{sname}.k_proj")
        v = e.linear3d(h, f"{sa}.v_proj", f"{sname}.v_proj")
        merged, kh, vh = _decode_self_attention(
            e, q, k, v, i, n_heads, head_size, max_len,
            ("bdheadshape", "bdmergeshape"), sname)
        att = e.linear3d(merged, f"{sa}.out_proj", f"{sname}.out_proj")
        presents.append((kh, vh))
        h = g.node("Add", [att, h], out=f"{name}/residual1")
        h = e.layernorm(h, f"{key}.self_attn_layer_norm",
                        f"{name}.self_attn_ln")
        xa, xname = f"{key}.encoder_attn", f"{name}.encoder_attn"
        q = _scaled_q(e, h, xa, head_size, "bscaling", xname)
        k = e.linear3d(memory, f"{xa}.k_proj", f"{xname}.k_proj")
        v = e.linear3d(memory, f"{xa}.v_proj", f"{xname}.v_proj")
        merged = _decode_cross_attention(e, q, k, v, n_heads, head_size,
                                         src_len,
                                         ("bxheadshape", "bdmergeshape"),
                                         xname)
        att = e.linear3d(merged, f"{xa}.out_proj", f"{xname}.out_proj")
        h = g.node("Add", [att, h], out=f"{name}/residual2")
        h = e.layernorm(h, f"{key}.encoder_attn_layer_norm",
                        f"{name}.encoder_attn_ln")
        f = _ffn(e, h, key, name)
        h = g.node("Add", [f, h], out=f"{name}/residual3")
        h = e.layernorm(h, f"{key}.final_layer_norm", f"{name}.final_ln")
    _lm_head(e, h)
    _step_outputs(g, presents, batch_size, n_heads, head_size,
                  int(cfg["vocab_size"]))
    return _finish(g, weights)


def random_bart_weights(config: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """A BartForConditionalGeneration state dict drawn as HF's
    ``_init_weights`` draws it: normal(0, ``init_std``) for every Linear
    weight and embedding (the shared embedding's padding row zero), zero
    biases, LayerNorm weight 1 and bias 0. The tied copies
    (``model.encoder/decoder.embed_tokens.weight``, ``lm_head.weight``) are
    the shared array; ``final_logits_bias`` is zeros."""
    cfg = _cfg(config)
    rng = np.random.default_rng(seed)
    std = np.float32(cfg["init_std"])
    d, vocab = int(cfg["d_model"]), int(cfg["vocab_size"])
    n_pos = int(cfg["max_position_embeddings"]) + _POS_OFFSET

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * std

    shared = normal(vocab, d)
    shared[int(cfg["pad_token_id"])] = 0.0
    w = {"model.shared.weight": shared,
         "model.encoder.embed_tokens.weight": shared,
         "model.decoder.embed_tokens.weight": shared,
         "lm_head.weight": shared,
         "final_logits_bias": np.zeros((1, vocab), np.float32)}

    def linear(key, n_out, n_in):
        w[f"{key}.weight"] = normal(n_out, n_in)
        w[f"{key}.bias"] = np.zeros(n_out, np.float32)

    def layernorm(key):
        w[f"{key}.weight"] = np.ones(d, np.float32)
        w[f"{key}.bias"] = np.zeros(d, np.float32)

    def attention(key):
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            linear(f"{key}.{proj}", d, d)

    for stack, side in (("model.encoder", "encoder"),
                        ("model.decoder", "decoder")):
        w[f"{stack}.embed_positions.weight"] = normal(n_pos, d)
        ffn = int(cfg[f"{side}_ffn_dim"])
        for i in range(int(cfg[f"{side}_layers"])):
            key = f"{stack}.layers.{i}"
            attention(f"{key}.self_attn")
            layernorm(f"{key}.self_attn_layer_norm")
            if side == "decoder":
                attention(f"{key}.encoder_attn")
                layernorm(f"{key}.encoder_attn_layer_norm")
            linear(f"{key}.fc1", ffn, d)
            linear(f"{key}.fc2", d, ffn)
            layernorm(f"{key}.final_layer_norm")
        layernorm(f"{stack}.layernorm_embedding")
    return w
