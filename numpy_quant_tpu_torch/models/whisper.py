"""Whisper-style speech encoder-decoder ONNX graphs, built from numpy
weights.

Port of ``numpy_quant_tpu/models/whisper.py``: ``whisper_seq2seq``,
``whisper_encoder``, ``whisper_decoder`` and ``whisper_decode_step`` emit
the same nodes, value names, attributes, inputs and outputs as their JAX
namesakes, from a state dict in HuggingFace's
``WhisperForConditionalGeneration`` key names instead of a live
``transformers`` module:

* front end        -> mel features [B, n_mels, 2 S] through Conv1d (kernel
                      3, pad 1) -> GELU -> Conv1d (kernel 3, stride 2, pad
                      1) -> GELU, the rank-3 Conv path, then Transpose
* positions        -> the encoder's sinusoid table baked as an initializer;
                      the decoder's learned table
* layers           -> pre-LN; attention is pre-scaled (q * 1/sqrt(d) right
                      after its projection, no Mul before Softmax), k_proj
                      has no bias; GELUs are exact erf
* head             -> MatMul with the token embedding^T (tied proj_out)

``generate_seq2seq`` feeds the float features to the encoder directly;
``generate_kv(..., memory=)`` drives the decode step with
``wpe=proto._wpe``.
"""
from __future__ import annotations

import math

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder
from .llama import _matmul_w
from .seq2seq import (_decode_cross_attention, _decode_self_attention,
                      _step_inputs, _step_outputs)
from .vit import _ViTEmitter, _f32

# openai/whisper-tiny (huggingface.co/openai/whisper-tiny/config.json)
WHISPER_TINY = {
    "vocab_size": 51865, "num_mel_bins": 80, "d_model": 384,
    "encoder_layers": 4, "encoder_attention_heads": 6, "decoder_layers": 4,
    "decoder_attention_heads": 6, "encoder_ffn_dim": 1536,
    "decoder_ffn_dim": 1536, "max_source_positions": 1500,
    "max_target_positions": 448, "activation_function": "gelu",
    "init_std": 0.02, "pad_token_id": 50257, "decoder_start_token_id": 50258,
}
_LN_EPS = 1e-5  # torch.nn.LayerNorm's default


def _cfg(config: dict) -> dict:
    cfg = dict(WHISPER_TINY, **config)
    if cfg["activation_function"] != "gelu":
        raise ValueError("the Whisper graphs emit the exact-erf GELU; "
                         f"activation_function {cfg['activation_function']!r} "
                         "is not built")
    return cfg


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper's encoder position table [length, channels] float32: sines
    then cosines of position x timescale, the timescales geometric from 1
    to 1 / max_timescale (HF's ``sinusoids``). The exponent and the
    position products are float32 as torch forms them; exp, sin and cos are
    taken in float64 and rounded once, so the table is torch's to within
    its last-ulp rounding of exp, sin and cos (1.5e-5 at 1500 x 384)."""
    inc = math.log(max_timescale) / (channels // 2 - 1)
    arg = np.float32(-inc) * np.arange(channels // 2, dtype=np.float32)
    inv = np.exp(arg.astype(np.float64)).astype(np.float32)
    scaled = (np.arange(length, dtype=np.float32)[:, None]
              * inv[None, :]).astype(np.float64)
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


def _q_scaled(e: _ViTEmitter, x: str, key: str, head_size: int,
              name: str) -> str:
    g = e.g
    q = e.linear3d(x, f"{key}.q_proj", f"{name}.q_proj")
    scal = g.const(np.array(np.float32(head_size ** -0.5), dtype=np.float32),
                   "wscaling")
    return g.node("Mul", [q, scal], out=f"{name}/q_scaled")


def _w_attention(e: _ViTEmitter, q_src: str, kv_src: str, key: str,
                 n_heads: int, name: str,
                 causal_len: int | None = None) -> str:
    """WhisperAttention: q scaled by 1/sqrt(d) right after its projection,
    bias-free k_proj, the optional additive causal initializer, softmax,
    context, out_proj."""
    g = e.g
    head_size = e.w[f"{key}.q_proj.weight"].shape[0] // n_heads
    q = _q_scaled(e, q_src, key, head_size, name)
    k = _matmul_w(g, kv_src, e.w[f"{key}.k_proj.weight"], f"{name}.k_proj")
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
    h = g.node("MatMul", [qh, kt], out=f"{name}/scores")
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


def _enc_layer(e: _ViTEmitter, x: str, key: str, n_heads: int,
               name: str) -> str:
    """WhisperEncoderLayer (pre-LN): x + attn(LN(x)), then x + ffn(LN(x))."""
    g = e.g
    ln = e.layernorm(x, f"{key}.self_attn_layer_norm", f"{name}.self_attn_ln")
    att = _w_attention(e, ln, ln, f"{key}.self_attn", n_heads,
                       f"{name}.self_attn")
    x = g.node("Add", [x, att], out=f"{name}/residual1")
    ln2 = e.layernorm(x, f"{key}.final_layer_norm", f"{name}.final_ln")
    f = _ffn(e, ln2, key, name)
    return g.node("Add", [x, f], out=f"{name}/residual2")


def _dec_layer(e: _ViTEmitter, x: str, memory: str, key: str, n_heads: int,
               tgt_len: int, name: str) -> str:
    """WhisperDecoderLayer (pre-LN): causal self-attention, cross-attention
    over the encoder memory, FFN."""
    g = e.g
    ln = e.layernorm(x, f"{key}.self_attn_layer_norm", f"{name}.self_attn_ln")
    att = _w_attention(e, ln, ln, f"{key}.self_attn", n_heads,
                       f"{name}.self_attn", causal_len=tgt_len)
    x = g.node("Add", [x, att], out=f"{name}/residual1")
    ln = e.layernorm(x, f"{key}.encoder_attn_layer_norm",
                     f"{name}.encoder_attn_ln")
    xa = _w_attention(e, ln, memory, f"{key}.encoder_attn", n_heads,
                      f"{name}.encoder_attn")
    x = g.node("Add", [x, xa], out=f"{name}/residual2")
    ln = e.layernorm(x, f"{key}.final_layer_norm", f"{name}.final_ln")
    f = _ffn(e, ln, key, name)
    return g.node("Add", [x, f], out=f"{name}/residual3")


def _emit_encoder(e: _ViTEmitter, cfg: dict, x: str) -> str:
    """Conv1d front end + GELUs + sinusoid positions + pre-LN layers + the
    final LayerNorm; the sequence is max_source_positions long after the
    stride-2 Conv."""
    g = e.g
    w = e.w
    src_len = int(cfg["max_source_positions"])
    c1w = g.init("conv1.weight", _f32(w["model.encoder.conv1.weight"]))
    c1b = g.init("conv1.bias", _f32(w["model.encoder.conv1.bias"]))
    h = g.node("Conv", [x, c1w, c1b], out="enc/conv1", pads=[1, 1],
               strides=[1], dilations=[1], group=1)
    h = e.gelu(h, "enc.gelu1")
    c2w = g.init("conv2.weight", _f32(w["model.encoder.conv2.weight"]))
    c2b = g.init("conv2.bias", _f32(w["model.encoder.conv2.bias"]))
    h = g.node("Conv", [h, c2w, c2b], out="enc/conv2", pads=[1, 1],
               strides=[2], dilations=[1], group=1)
    h = e.gelu(h, "enc.gelu2")
    h = g.node("Transpose", [h], out="enc/permute", perm=[0, 2, 1])
    pos = g.init("encoder.pos",
                 _f32(w["model.encoder.embed_positions.weight"])[:src_len])
    h = g.node("Add", [h, pos], out="enc/pos_add")
    for i in range(int(cfg["encoder_layers"])):
        h = _enc_layer(e, h, f"model.encoder.layers.{i}",
                       int(cfg["encoder_attention_heads"]), f"encoder.{i}")
    return e.layernorm(h, "model.encoder.layer_norm", "encoder.final_norm")


def _head(e: _ViTEmitter, h: str) -> None:
    """The final LayerNorm, then the tied head: logits = h @ embed^T."""
    h = e.layernorm(h, "model.decoder.layer_norm", "decoder.final_norm")
    head = e.g.init("proj_out.weight_t", np.ascontiguousarray(
        _f32(e.w["model.decoder.embed_tokens.weight"]).T))
    e.g.node("MatMul", [h, head], out="logits", name="proj_out")


def _emit_decoder(e: _ViTEmitter, cfg: dict, x: str, memory: str,
                  tgt_len: int) -> str:
    g = e.g
    pos = g.init("decoder.pos", _f32(
        e.w["model.decoder.embed_positions.weight"])[:tgt_len])
    h = g.node("Add", [x, pos], out="dec/pos_add")
    for i in range(int(cfg["decoder_layers"])):
        h = _dec_layer(e, h, memory, f"model.decoder.layers.{i}",
                       int(cfg["decoder_attention_heads"]), tgt_len,
                       f"decoder.{i}")
    _head(e, h)
    return "logits"


def _finish(g: GraphBuilder, weights: dict) -> O.ModelProto:
    """The proto with ``_wte`` [vocab, d] and ``_wpe`` [max target
    positions, d], the decoder's token and position tables, riding on it."""
    model = g.model()
    model._wte = _f32(weights["model.decoder.embed_tokens.weight"])
    model._wpe = _f32(weights["model.decoder.embed_positions.weight"])
    return model


def _features(g: GraphBuilder, cfg: dict, batch_size: int) -> str:
    return g.input("input_features",
                   [batch_size, int(cfg["num_mel_bins"]),
                    2 * int(cfg["max_source_positions"])])


def whisper_seq2seq(weights: dict, config: dict, batch_size: int = 2,
                    tgt_len: int = 8) -> O.ModelProto:
    """The full graph: ``input_features`` [B, n_mels, 2 S] +
    ``decoder_embeds`` [B, T, d] -> ``logits`` [B, T, V]."""
    cfg = _cfg(config)
    g = GraphBuilder("whisper_seq2seq")
    e = _ViTEmitter(g, weights, _LN_EPS)
    x = _features(g, cfg, batch_size)
    xd = g.input("decoder_embeds", [batch_size, tgt_len, int(cfg["d_model"])])
    memory = _emit_encoder(e, cfg, x)
    _emit_decoder(e, cfg, xd, memory, tgt_len)
    g.output("logits", [batch_size, tgt_len, int(cfg["vocab_size"])])
    return _finish(g, weights)


def whisper_encoder(weights: dict, config: dict,
                    batch_size: int = 2) -> O.ModelProto:
    """The encoder alone: ``input_features`` -> ``encoder_memory``
    [B, S, d], run once per utterance."""
    cfg = _cfg(config)
    g = GraphBuilder("whisper_encoder")
    e = _ViTEmitter(g, weights, _LN_EPS)
    x = _features(g, cfg, batch_size)
    memory = _emit_encoder(e, cfg, x)
    g.node("Identity", [memory], out="encoder_memory", name="memory_id")
    g.output("encoder_memory", [batch_size, int(cfg["max_source_positions"]),
                                int(cfg["d_model"])])
    return _finish(g, weights)


def whisper_decoder(weights: dict, config: dict, batch_size: int = 2,
                    tgt_len: int = 8) -> O.ModelProto:
    """The decoder alone: ``decoder_embeds`` [B, T, d] + ``encoder_memory``
    [B, S, d] -> ``logits``, run once per token against the memory."""
    cfg = _cfg(config)
    d = int(cfg["d_model"])
    g = GraphBuilder("whisper_decoder")
    e = _ViTEmitter(g, weights, _LN_EPS)
    xd = g.input("decoder_embeds", [batch_size, tgt_len, d])
    memory = g.input("encoder_memory",
                     [batch_size, int(cfg["max_source_positions"]), d])
    _emit_decoder(e, cfg, xd, memory, tgt_len)
    g.output("logits", [batch_size, tgt_len, int(cfg["vocab_size"])])
    return _finish(g, weights)


def whisper_decode_step(weights: dict, config: dict, batch_size: int = 2,
                        max_len: int = 8) -> O.ModelProto:
    """The KV-cache decode form of the Whisper decoder, one token per call.

    Inputs, in order: ``x_step`` [B, 1, d] (token embedding + position,
    added by ``generate_kv`` with ``wpe=proto._wpe``), ``attn_mask``
    [1, 1, 1, L+1] additive, ``encoder_memory`` [B, S, d] (the encoder's
    output, fed by ``generate_kv(..., memory=)``), then ``past_k.i``/
    ``past_v.i`` [B, H, L, D] per layer. Outputs: ``logits`` [B, 1, V],
    then ``present_k.i``/``present_v.i`` [B, H, 1, D] per layer."""
    cfg = _cfg(config)
    w = weights
    d = int(cfg["d_model"])
    n_heads = int(cfg["decoder_attention_heads"])
    head_size = d // n_heads
    n_layer = int(cfg["decoder_layers"])
    src_len = int(cfg["max_source_positions"])
    g = GraphBuilder("whisper_decode_step")
    e = _ViTEmitter(g, w, _LN_EPS)
    h, memory = _step_inputs(g, batch_size, d, max_len, src_len, n_layer,
                             n_heads, head_size)
    presents = []
    for i in range(n_layer):
        key, name = f"model.decoder.layers.{i}", f"decoder.{i}"
        ln = e.layernorm(h, f"{key}.self_attn_layer_norm",
                         f"{name}.self_attn_ln")
        sa, sname = f"{key}.self_attn", f"{name}.self_attn"
        q = _q_scaled(e, ln, sa, head_size, sname)
        k = _matmul_w(g, ln, w[f"{sa}.k_proj.weight"], f"{sname}.k_proj")
        v = e.linear3d(ln, f"{sa}.v_proj", f"{sname}.v_proj")
        merged, kh, vh = _decode_self_attention(
            e, q, k, v, i, n_heads, head_size, max_len,
            ("wdheadshape", "wdmergeshape"), sname)
        att = e.linear3d(merged, f"{sa}.out_proj", f"{sname}.out_proj")
        presents.append((kh, vh))
        h = g.node("Add", [h, att], out=f"{name}/residual1")
        ln = e.layernorm(h, f"{key}.encoder_attn_layer_norm",
                         f"{name}.encoder_attn_ln")
        xa, xname = f"{key}.encoder_attn", f"{name}.encoder_attn"
        q = _q_scaled(e, ln, xa, head_size, xname)
        k = _matmul_w(g, memory, w[f"{xa}.k_proj.weight"], f"{xname}.k_proj")
        v = e.linear3d(memory, f"{xa}.v_proj", f"{xname}.v_proj")
        merged = _decode_cross_attention(e, q, k, v, n_heads, head_size,
                                         src_len,
                                         ("wxheadshape", "wdmergeshape"),
                                         xname)
        att = e.linear3d(merged, f"{xa}.out_proj", f"{xname}.out_proj")
        h = g.node("Add", [h, att], out=f"{name}/residual2")
        ln = e.layernorm(h, f"{key}.final_layer_norm", f"{name}.final_ln")
        f = _ffn(e, ln, key, name)
        h = g.node("Add", [h, f], out=f"{name}/residual3")
    _head(e, h)
    _step_outputs(g, presents, batch_size, n_heads, head_size,
                  int(cfg["vocab_size"]))
    return _finish(g, w)


def random_whisper_weights(config: dict,
                           seed: int = 0) -> dict[str, np.ndarray]:
    """A WhisperForConditionalGeneration state dict drawn as HF's
    ``_init_weights`` draws it: normal(0, ``init_std``) for every Linear
    and Conv1d weight and the decoder's embeddings (the token table's
    padding row zero), zero biases, LayerNorm weight 1 and bias 0, and the
    encoder's position table Whisper's sinusoids. ``proj_out.weight`` is the
    token table (tied)."""
    cfg = _cfg(config)
    rng = np.random.default_rng(seed)
    std = np.float32(cfg["init_std"])
    d, vocab = int(cfg["d_model"]), int(cfg["vocab_size"])
    mels = int(cfg["num_mel_bins"])

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * std

    w: dict[str, np.ndarray] = {}

    def linear(key, n_out, n_in, bias=True):
        w[f"{key}.weight"] = normal(n_out, n_in)
        if bias:
            w[f"{key}.bias"] = np.zeros(n_out, np.float32)

    def layernorm(key):
        w[f"{key}.weight"] = np.ones(d, np.float32)
        w[f"{key}.bias"] = np.zeros(d, np.float32)

    def attention(key):
        linear(f"{key}.k_proj", d, d, bias=False)
        linear(f"{key}.v_proj", d, d)
        linear(f"{key}.q_proj", d, d)
        linear(f"{key}.out_proj", d, d)

    w["model.encoder.conv1.weight"] = normal(d, mels, 3)
    w["model.encoder.conv1.bias"] = np.zeros(d, np.float32)
    w["model.encoder.conv2.weight"] = normal(d, d, 3)
    w["model.encoder.conv2.bias"] = np.zeros(d, np.float32)
    w["model.encoder.embed_positions.weight"] = sinusoids(
        int(cfg["max_source_positions"]), d)
    tokens = normal(vocab, d)
    tokens[int(cfg["pad_token_id"])] = 0.0
    for stack, side in (("model.encoder", "encoder"),
                        ("model.decoder", "decoder")):
        if side == "decoder":
            w["model.decoder.embed_tokens.weight"] = tokens
            w["model.decoder.embed_positions.weight"] = normal(
                int(cfg["max_target_positions"]), d)
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
        layernorm(f"{stack}.layer_norm")
    w["proj_out.weight"] = tokens
    return w
