"""LLaMA-style causal decoder ONNX graphs (RMSNorm + RoPE + SwiGLU +
grouped-query attention), built from numpy weights.

Port of ``numpy_quant_tpu/models/llama.py::llama_causal_lm``: the same
nodes, value names, attributes, inputs and outputs, emitted from a state
dict in HuggingFace's ``LlamaForCausalLM`` key names
(``model.layers.{i}.self_attn.q_proj.weight``, ...) instead of a live
``transformers`` module:

* RMSNorm        -> Mul/ReduceMean/Add(eps)/Sqrt/Div/Mul(weight) nodes
* Linear, no bias -> MatMul against the transposed weight
* RoPE            -> cos/sin initializers [1, 1, N, head_dim] at the graph's
                     fixed length, applied with the Slice/Neg/Concat
                     rotate_half idiom
* repeat_kv (GQA) -> Unsqueeze/Expand/Reshape
* SwiGLU          -> down(gate * Sigmoid(gate) * up)
* LM head         -> MatMul with lm_head^T (not tied)

An optional ``sliding_window`` config key bands the causal mask
(Mistral-style attention); ``mistral_causal_lm`` and
``mistral_default_config`` are the JAX package's named entry points over
it. The graph takes float ``inputs_embeds`` [batch, seq, hidden]; the
token embedding is a host gather from ``_wte``, which rides on the
returned proto.

``llama_decode_step`` (the one-token KV-cache form, RoPE rows as inputs)
and ``llama_prefill`` (one prompt in one call, exposing every layer's
cache-layout K/V) are ports of their JAX namesakes, node for node.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import onnx as O
from ..onnx.builder import GraphBuilder
from .vit import _f32

# TinyLlama-1.1B (huggingface.co/TinyLlama/
# TinyLlama-1.1B-intermediate-step-1431k-3T/config.json): LLaMA-2
# architecture with grouped-query attention, 8 query heads per KV head
TINYLLAMA_1_1B = {
    "vocab_size": 32000, "hidden_size": 2048, "intermediate_size": 5632,
    "num_hidden_layers": 22, "num_attention_heads": 32,
    "num_key_value_heads": 4, "max_position_embeddings": 2048,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "initializer_range": 0.02,
    "tie_word_embeddings": False,
}


def _cfg(config: dict) -> dict:
    cfg = dict(TINYLLAMA_1_1B, **config)
    cfg.setdefault("head_dim",
                   int(cfg["hidden_size"]) // int(cfg["num_attention_heads"]))
    if cfg.get("tie_word_embeddings"):
        raise ValueError("tied LM heads are not built: the graph reads "
                         "lm_head.weight")
    return cfg


def _rms_norm(g: GraphBuilder, x: str, weight: np.ndarray, eps: float,
              name: str) -> str:
    """LlamaRMSNorm: x / sqrt(mean(x^2, -1) + eps) * weight."""
    sq = g.node("Mul", [x, x], out=f"{name}/Sq_out")
    var = g.node("ReduceMean", [sq], out=f"{name}/Var_out", axes=[-1],
                 keepdims=1)
    e = g.const(np.array(np.float32(eps), dtype=np.float32), "rmseps")
    ve = g.node("Add", [var, e], out=f"{name}/AddEps_out")
    std = g.node("Sqrt", [ve], out=f"{name}/Sqrt_out")
    normed = g.node("Div", [x, std], out=f"{name}/Div_out")
    w = g.init(f"{name}.weight", _f32(weight))
    return g.node("Mul", [normed, w], out=f"{name}/Mul_out")


def _matmul_w(g: GraphBuilder, x: str, weight: np.ndarray, name: str) -> str:
    """torch Linear without bias (weight [out, in]): one MatMul against
    the transposed weight."""
    w = g.init(f"{name}.weight_t", np.ascontiguousarray(_f32(weight).T))
    return g.node("MatMul", [x, w], out=f"{name}/MatMul_out")


def _rotate_half(g: GraphBuilder, t: str, head_dim: int, name: str) -> str:
    """rotate_half(x) = concat(-x[..., d/2:], x[..., :d/2])."""
    z = g.const(np.array([0], dtype=np.int64), "rh_zero")
    h = g.const(np.array([head_dim // 2], dtype=np.int64), "rh_half")
    d = g.const(np.array([head_dim], dtype=np.int64), "rh_full")
    ax = g.const(np.array([-1], dtype=np.int64), "rh_axis")
    lo = g.node("Slice", [t, z, h, ax], out=f"{name}/lo")
    hi = g.node("Slice", [t, h, d, ax], out=f"{name}/hi")
    neg = g.node("Neg", [hi], out=f"{name}/neg_hi")
    return g.node("Concat", [neg, lo], out=f"{name}/rotated", axis=-1)


def _apply_rope(g: GraphBuilder, t: str, cos: str, sin: str, head_dim: int,
                name: str) -> str:
    """t*cos + rotate_half(t)*sin on [B, heads, N, head_dim] (cos/sin
    broadcast from [1, 1, N, head_dim])."""
    tc = g.node("Mul", [t, cos], out=f"{name}/cos_mul")
    rot = _rotate_half(g, t, head_dim, name)
    ts = g.node("Mul", [rot, sin], out=f"{name}/sin_mul")
    return g.node("Add", [tc, ts], out=f"{name}/roped")


def _repeat_kv(g: GraphBuilder, t: str, n_kv: int, n_rep: int, seq: int,
               head_dim: int, name: str) -> str:
    """HF repeat_kv: [B, n_kv, N, D] -> [B, n_kv*n_rep, N, D] by
    interleaved repetition (Unsqueeze + Expand + Reshape)."""
    if n_rep == 1:
        return t
    ax2 = g.const(np.array([2], dtype=np.int64), "rkv_axes2")
    u = g.node("Unsqueeze", [t, ax2], out=f"{name}/unsq")
    target = g.const(np.array([1, n_kv, n_rep, seq, head_dim],
                              dtype=np.int64), "rkv_target")
    x = g.node("Expand", [u, target], out=f"{name}/expanded")
    merged = g.const(np.array([0, n_kv * n_rep, seq, head_dim],
                              dtype=np.int64), "rkv_merged")
    return g.node("Reshape", [x, merged], out=f"{name}/merged")


def rope_tables(config: dict, seq_len: int) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin [1, 1, seq_len, head_dim] float32 of HF's default RoPE
    (LlamaRotaryEmbedding, no scaling), computed on the host with the same
    torch operations, so the tables are the same wherever the graph is
    built."""
    cfg = _cfg(config)
    d = int(cfg["head_dim"])
    with torch.no_grad():
        exponents = torch.arange(0, d, 2, dtype=torch.int64) \
            .to(dtype=torch.float) / d
        inv_freq = 1.0 / (float(cfg["rope_theta"]) ** exponents)
        inv_freq = inv_freq[None, :, None].float().expand(1, -1, 1)
        positions = torch.arange(seq_len)[None][:, None, :].float()
        freqs = (inv_freq.float() @ positions.float()).transpose(1, 2)
        emb = torch.cat((freqs, freqs), dim=-1)
        cos, sin = emb.cos() * 1.0, emb.sin() * 1.0
    return cos.numpy()[None].astype(np.float32), \
        sin.numpy()[None].astype(np.float32)


def _llama_attention(g: GraphBuilder, w: dict, x: str, cfg: dict, key: str,
                     seq_len: int, cos: str, sin: str, name: str,
                     window: int | None = None,
                     presents: list | None = None) -> str:
    """LlamaAttention (eager): q/k/v projections, RoPE on q and k,
    grouped-query repeat of k and v, scaled scores plus the causal additive
    mask (banded by ``window``), softmax, context, o_proj. ``presents``
    collects (k, v) in the decode cache layout: post-RoPE k, pre-repeat
    KV heads."""
    n_heads = int(cfg["num_attention_heads"])
    n_kv = int(cfg["num_key_value_heads"])
    head_dim = int(cfg["head_dim"])
    n_rep = n_heads // n_kv

    q = _matmul_w(g, x, w[f"{key}.q_proj.weight"], f"{name}.q_proj")
    k = _matmul_w(g, x, w[f"{key}.k_proj.weight"], f"{name}.k_proj")
    v = _matmul_w(g, x, w[f"{key}.v_proj.weight"], f"{name}.v_proj")

    def split_heads(t: str, n: int, which: str) -> str:
        shape = g.const(np.array([0, seq_len, n, head_dim], dtype=np.int64),
                        f"headshape{n}")
        r = g.node("Reshape", [t, shape], out=f"{name}/{which}_Reshape")
        return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                      perm=[0, 2, 1, 3])

    qh = split_heads(q, n_heads, "q")
    kh = split_heads(k, n_kv, "k")
    vh = split_heads(v, n_kv, "v")
    qh = _apply_rope(g, qh, cos, sin, head_dim, f"{name}/q_rope")
    kh = _apply_rope(g, kh, cos, sin, head_dim, f"{name}/k_rope")
    if presents is not None:
        presents.append((kh, vh))
    kh = _repeat_kv(g, kh, n_kv, n_rep, seq_len, head_dim, f"{name}/k_rep")
    vh = _repeat_kv(g, vh, n_kv, n_rep, seq_len, head_dim, f"{name}/v_rep")

    kt = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
    scores = g.node("MatMul", [qh, kt], out=f"{name}/scores")
    scal = g.const(np.array(np.float32(head_dim ** -0.5), dtype=np.float32),
                   "scaling")
    scaled = g.node("Mul", [scores, scal], out=f"{name}/scaled")
    i, j = np.indices((seq_len, seq_len))
    visible = (j <= i) if window is None \
        else (j <= i) & (j > i - int(window))
    mask = np.where(visible, np.float32(0), np.float32(-1e9))
    mc = g.init(f"{name}.causal_mask", mask[None, None].astype(np.float32))
    masked = g.node("Add", [scaled, mc], out=f"{name}/masked")
    probs = g.node("Softmax", [masked], out=f"{name}/probs", axis=-1)
    ctx = g.node("MatMul", [probs, vh], out=f"{name}/context")
    ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                 perm=[0, 2, 1, 3])
    merge = g.const(np.array([0, seq_len, n_heads * head_dim],
                             dtype=np.int64), "mergeshape")
    merged = g.node("Reshape", [ctx, merge], out=f"{name}/merged")
    return _matmul_w(g, merged, w[f"{key}.o_proj.weight"], f"{name}.o_proj")


def _swiglu_mlp(g: GraphBuilder, w: dict, x: str, key: str, name: str) -> str:
    """LlamaMLP: down_proj(silu(gate_proj(x)) * up_proj(x)), SiLU as
    Sigmoid * x (the torch exporter's decomposition)."""
    gate = _matmul_w(g, x, w[f"{key}.gate_proj.weight"], f"{name}.gate_proj")
    sig = g.node("Sigmoid", [gate], out=f"{name}/Sigmoid_out")
    silu = g.node("Mul", [gate, sig], out=f"{name}/SiLU_out")
    up = _matmul_w(g, x, w[f"{key}.up_proj.weight"], f"{name}.up_proj")
    h = g.node("Mul", [silu, up], out=f"{name}/Gate_out")
    return _matmul_w(g, h, w[f"{key}.down_proj.weight"], f"{name}.down_proj")


def _llama_block(g: GraphBuilder, w: dict, x: str, cfg: dict, i: int,
                 seq_len: int, cos: str, sin: str,
                 window: int | None = None,
                 presents: list | None = None) -> str:
    """LlamaDecoderLayer: pre-RMSNorm attention + residual, pre-RMSNorm
    SwiGLU MLP + residual."""
    key, name = f"model.layers.{i}", f"layers.{i}"
    eps = float(cfg["rms_norm_eps"])
    ln1 = _rms_norm(g, x, w[f"{key}.input_layernorm.weight"], eps,
                    f"{name}.input_norm")
    att = _llama_attention(g, w, ln1, cfg, f"{key}.self_attn", seq_len, cos,
                           sin, f"{name}.self_attn", window=window,
                           presents=presents)
    x1 = g.node("Add", [att, x], out=f"{name}/residual1")
    ln2 = _rms_norm(g, x1, w[f"{key}.post_attention_layernorm.weight"], eps,
                    f"{name}.post_norm")
    mlp = _swiglu_mlp(g, w, ln2, f"{key}.mlp", f"{name}.mlp")
    return g.node("Add", [mlp, x1], out=f"{name}/residual2")


def llama_causal_lm(weights: dict, config: dict, batch_size: int = 2,
                    seq_len: int = 16) -> O.ModelProto:
    """LlamaForCausalLM over float ``inputs_embeds`` [batch, seq, hidden]
    -> ``logits`` [batch, seq, vocab]. The RoPE tables and the causal mask
    bake in at this fixed seq_len; every head reshape copies the batch dim
    and the tables and mask broadcast over it, so the graph runs any
    batch."""
    cfg = _cfg(config)
    g = GraphBuilder("llama_causal_lm")
    h = g.input("inputs_embeds", [batch_size, seq_len,
                                  int(cfg["hidden_size"])])
    cos_np, sin_np = rope_tables(cfg, seq_len)
    cos = g.init("rope.cos", cos_np)
    sin = g.init("rope.sin", sin_np)
    window = cfg.get("sliding_window")
    for i in range(int(cfg["num_hidden_layers"])):
        h = _llama_block(g, weights, h, cfg, i, seq_len, cos, sin,
                         window=window)
    _lm_head(g, weights, h, cfg)
    g.output("logits", [batch_size, seq_len, int(cfg["vocab_size"])])
    return _finish(g, weights, cfg)


def mistral_default_config(seq_len: int = 16,
                           sliding_window: int = 6) -> dict:
    """The tiny Mistral config of the JAX package's tests: the LLaMA block
    (2 layers, hidden 32, 4 heads, 2 KV heads, vocabulary 96) with
    sliding-window attention, at HF ``MistralConfig``'s defaults
    otherwise."""
    return {"vocab_size": 96, "hidden_size": 32, "intermediate_size": 48,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 2, "sliding_window": sliding_window,
            "max_position_embeddings": seq_len, "rms_norm_eps": 1e-6,
            "rope_theta": 10000.0, "initializer_range": 0.02,
            "tie_word_embeddings": False}


def mistral_causal_lm(weights: dict, config: dict | None = None,
                      batch_size: int = 2,
                      seq_len: int = 16) -> O.ModelProto:
    """A Mistral-style causal LM: the LLaMA block structure (RMSNorm, RoPE,
    SwiGLU, grouped-query attention) with sliding-window attention, the
    banded causal mask constant that ``optimize()`` folds into the fused
    kernels' ``causal_window``. ``weights`` are a ``MistralForCausalLM``
    state dict (LLaMA's key names; ``random_llama_weights`` draws one);
    ``config`` defaults to :func:`mistral_default_config` at ``seq_len``."""
    if config is None:
        config = mistral_default_config(seq_len)
    if not config.get("sliding_window"):
        raise ValueError("a Mistral config sets sliding_window")
    return llama_causal_lm(weights, config, batch_size=batch_size,
                           seq_len=seq_len)


def _lm_head(g: GraphBuilder, weights: dict, h: str, cfg: dict) -> None:
    """The final RMSNorm and the untied LM head, into ``logits``."""
    h = _rms_norm(g, h, weights["model.norm.weight"],
                  float(cfg["rms_norm_eps"]), "norm")
    head = g.init("lm_head.weight_t",
                  np.ascontiguousarray(_f32(weights["lm_head.weight"]).T))
    g.node("MatMul", [h, head], out="logits", name="lm_head")


def _present_outputs(g: GraphBuilder, presents: list, shape: list) -> None:
    """``present_k.i``/``present_v.i`` graph outputs of ``shape``, one
    Identity each."""
    for i, (kh, vh) in enumerate(presents):
        g.node("Identity", [kh], out=f"present_k.{i}",
               name=f"present_k_id.{i}")
        g.node("Identity", [vh], out=f"present_v.{i}",
               name=f"present_v_id.{i}")
        g.output(f"present_k.{i}", shape)
        g.output(f"present_v.{i}", shape)


def _finish(g: GraphBuilder, weights: dict, cfg: dict,
            rope_len: int | None = None) -> O.ModelProto:
    """The proto with the host tables that ride on it: ``_wte`` [vocab,
    hidden], ``_head_dim`` and, for the decode forms, ``_rope_tables``
    (cos, sin) [1, 1, rope_len, head_dim]."""
    model = g.model()
    model._wte = _f32(weights["model.embed_tokens.weight"])
    model._head_dim = int(cfg["head_dim"])
    if rope_len is not None:
        model._rope_tables = rope_tables(cfg, rope_len)
    return model


def _llama_decode_attention(g: GraphBuilder, w: dict, x: str, cfg: dict,
                            key: str, layer: int, max_len: int,
                            name: str) -> tuple[str, str, str]:
    """One-token LLaMA attention against a fixed-length rotated-k cache:
    RoPE on the current q and k from the ``cos_step``/``sin_step`` inputs,
    grouped-query repeat of the caches and of the step k/v, scores over
    [cache | current] (L+1 lanes) with the additive ``attn_mask`` input,
    and the probabilities split back into a cache product plus a self term.
    Returns (o_proj output, k_step, v_step); k_step is rotated, so cached
    keys need no position fix-up."""
    n_heads = int(cfg["num_attention_heads"])
    n_kv = int(cfg["num_key_value_heads"])
    head_dim = int(cfg["head_dim"])
    n_rep = n_heads // n_kv

    q = _matmul_w(g, x, w[f"{key}.q_proj.weight"], f"{name}.q_proj")
    k = _matmul_w(g, x, w[f"{key}.k_proj.weight"], f"{name}.k_proj")
    v = _matmul_w(g, x, w[f"{key}.v_proj.weight"], f"{name}.v_proj")

    def split_heads(t: str, n: int, which: str) -> str:
        shape = g.const(np.array([0, 1, n, head_dim], dtype=np.int64),
                        f"dheadshape{n}")
        r = g.node("Reshape", [t, shape], out=f"{name}/{which}_Reshape")
        return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                      perm=[0, 2, 1, 3])

    qh = split_heads(q, n_heads, "q")
    kh = split_heads(k, n_kv, "k")
    vh = split_heads(v, n_kv, "v")
    qh = _apply_rope(g, qh, "cos_step", "sin_step", head_dim,
                     f"{name}/q_rope")
    kh = _apply_rope(g, kh, "cos_step", "sin_step", head_dim,
                     f"{name}/k_rope")

    k_cache = _repeat_kv(g, f"past_k.{layer}", n_kv, n_rep, max_len,
                         head_dim, f"{name}/kc_rep")
    v_cache = _repeat_kv(g, f"past_v.{layer}", n_kv, n_rep, max_len,
                         head_dim, f"{name}/vc_rep")
    kh_full = _repeat_kv(g, kh, n_kv, n_rep, 1, head_dim, f"{name}/k_rep")
    vh_full = _repeat_kv(g, vh, n_kv, n_rep, 1, head_dim, f"{name}/v_rep")

    kt_cache = g.node("Transpose", [k_cache], out=f"{name}/cache_k_T",
                      perm=[0, 1, 3, 2])
    s_past = g.node("MatMul", [qh, kt_cache], out=f"{name}/scores_past")
    kt_step = g.node("Transpose", [kh_full], out=f"{name}/k_T",
                     perm=[0, 1, 3, 2])
    s_self = g.node("MatMul", [qh, kt_step], out=f"{name}/scores_self")
    s = g.node("Concat", [s_past, s_self], out=f"{name}/scores", axis=-1)
    scal = g.const(np.array(np.float32(head_dim ** -0.5), dtype=np.float32),
                   "scaling")
    scaled = g.node("Mul", [s, scal], out=f"{name}/scaled")
    masked = g.node("Add", [scaled, "attn_mask"], out=f"{name}/masked")
    probs = g.node("Softmax", [masked], out=f"{name}/probs", axis=-1)

    z = g.const(np.array([0], dtype=np.int64), "zero")
    ll = g.const(np.array([max_len], dtype=np.int64), "maxlen")
    lp1 = g.const(np.array([max_len + 1], dtype=np.int64), "maxlenp1")
    ax = g.const(np.array([-1], dtype=np.int64), "lastaxis")
    p_past = g.node("Slice", [probs, z, ll, ax], out=f"{name}/p_past")
    p_self = g.node("Slice", [probs, ll, lp1, ax], out=f"{name}/p_self")
    ctx = g.node("MatMul", [p_past, v_cache], out=f"{name}/ctx_past")
    self_ctx = g.node("Mul", [p_self, vh_full], out=f"{name}/ctx_self")
    ctx = g.node("Add", [ctx, self_ctx], out=f"{name}/context")

    ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                 perm=[0, 2, 1, 3])
    merge = g.const(np.array([0, 1, n_heads * head_dim], dtype=np.int64),
                    "dmergeshape")
    merged = g.node("Reshape", [ctx, merge], out=f"{name}/merged")
    return (_matmul_w(g, merged, w[f"{key}.o_proj.weight"],
                      f"{name}.o_proj"), kh, vh)


def llama_decode_step(weights: dict, config: dict, batch_size: int = 2,
                      max_len: int = 16) -> O.ModelProto:
    """The KV-cache decode form of :func:`llama_causal_lm` (one token per
    call, O(L) per token). Inputs, in order: ``x_step`` [B, 1, H],
    ``attn_mask`` [1, 1, 1, L+1] additive, ``cos_step``/``sin_step``
    [1, 1, 1, head_dim] (the RoPE row of the current position, gathered by
    the caller: utils/generate.py::generate_kv with ``rope=``), then
    ``past_k.i``/``past_v.i`` [B, n_kv_heads, L, head_dim] per layer.
    Outputs: ``logits`` [B, 1, V], then per layer ``present_k.i``/
    ``present_v.i`` [B, n_kv_heads, 1, head_dim] (k rotated). The tables
    ride on the proto: ``_wte``, ``_head_dim`` and ``_rope_tables`` at
    ``max_len`` positions."""
    cfg = _cfg(config)
    n_kv, head_dim = int(cfg["num_key_value_heads"]), int(cfg["head_dim"])
    eps = float(cfg["rms_norm_eps"])
    g = GraphBuilder("llama_decode_step")
    h = g.input("x_step", [batch_size, 1, int(cfg["hidden_size"])])
    g.input("attn_mask", [1, 1, 1, max_len + 1])
    g.input("cos_step", [1, 1, 1, head_dim])
    g.input("sin_step", [1, 1, 1, head_dim])
    layers = int(cfg["num_hidden_layers"])
    for i in range(layers):
        g.input(f"past_k.{i}", [batch_size, n_kv, max_len, head_dim])
        g.input(f"past_v.{i}", [batch_size, n_kv, max_len, head_dim])

    presents = []
    for i in range(layers):
        key, name = f"model.layers.{i}", f"layers.{i}"
        ln1 = _rms_norm(g, h, weights[f"{key}.input_layernorm.weight"], eps,
                        f"{name}.input_norm")
        att, kh, vh = _llama_decode_attention(
            g, weights, ln1, cfg, f"{key}.self_attn", i, max_len,
            f"{name}.self_attn")
        presents.append((kh, vh))
        x1 = g.node("Add", [att, h], out=f"{name}/residual1")
        ln2 = _rms_norm(g, x1,
                        weights[f"{key}.post_attention_layernorm.weight"],
                        eps, f"{name}.post_norm")
        mlp = _swiglu_mlp(g, weights, ln2, f"{key}.mlp", f"{name}.mlp")
        h = g.node("Add", [mlp, x1], out=f"{name}/residual2")
    _lm_head(g, weights, h, cfg)
    g.output("logits", [batch_size, 1, int(cfg["vocab_size"])])
    _present_outputs(g, presents, [batch_size, n_kv, 1, head_dim])
    return _finish(g, weights, cfg, rope_len=max_len)


def llama_prefill(weights: dict, config: dict,
                  prefill_len: int = 8) -> O.ModelProto:
    """The prefill form of :func:`llama_causal_lm`: one request's prompt
    in one call, exposing every layer's cache-layout K/V:
    ``inputs_embeds`` [1, P, H] -> ``logits`` [1, P, V] plus
    ``present_k.i``/``present_v.i`` [1, n_kv_heads, P, head_dim] (post-RoPE
    k, pre-repeat KV heads: what :func:`llama_decode_step`'s cache inputs
    take). The RoPE tables and the causal mask bake in at positions
    0..P-1; a shorter prompt pads on the right (the causal mask keeps the
    padding out of the live rows). ``_rope_tables`` rides on the proto at
    ``max_position_embeddings`` positions, for the decode that follows."""
    cfg = _cfg(config)
    n_kv, head_dim = int(cfg["num_key_value_heads"]), int(cfg["head_dim"])
    g = GraphBuilder("llama_prefill")
    h = g.input("inputs_embeds", [1, prefill_len, int(cfg["hidden_size"])])
    cos_np, sin_np = rope_tables(cfg, prefill_len)
    cos = g.init("rope.cos", cos_np)
    sin = g.init("rope.sin", sin_np)
    window = cfg.get("sliding_window")
    presents = []
    for i in range(int(cfg["num_hidden_layers"])):
        h = _llama_block(g, weights, h, cfg, i, prefill_len, cos, sin,
                         window=window, presents=presents)
    _lm_head(g, weights, h, cfg)
    g.output("logits", [1, prefill_len, int(cfg["vocab_size"])])
    _present_outputs(g, presents, [1, n_kv, prefill_len, head_dim])
    return _finish(g, weights, cfg,
                   rope_len=int(cfg["max_position_embeddings"]))


def random_llama_weights(config: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """A LlamaForCausalLM state dict drawn like HF's init: normal(0,
    ``initializer_range``) for the embedding, every projection and the LM
    head, RMSNorm weights 1."""
    cfg = _cfg(config)
    rng = np.random.default_rng(seed)
    std = np.float32(cfg["initializer_range"])
    hid, inter = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    hd = int(cfg["head_dim"])
    q_out = int(cfg["num_attention_heads"]) * hd
    kv_out = int(cfg["num_key_value_heads"]) * hd

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * std

    w = {"model.embed_tokens.weight": normal(int(cfg["vocab_size"]), hid)}
    for i in range(int(cfg["num_hidden_layers"])):
        key = f"model.layers.{i}"
        for proj, (n_out, n_in) in (("q_proj", (q_out, hid)),
                                    ("k_proj", (kv_out, hid)),
                                    ("v_proj", (kv_out, hid)),
                                    ("o_proj", (hid, q_out))):
            w[f"{key}.self_attn.{proj}.weight"] = normal(n_out, n_in)
        for proj, (n_out, n_in) in (("gate_proj", (inter, hid)),
                                    ("up_proj", (inter, hid)),
                                    ("down_proj", (hid, inter))):
            w[f"{key}.mlp.{proj}.weight"] = normal(n_out, n_in)
        w[f"{key}.input_layernorm.weight"] = np.ones(hid, np.float32)
        w[f"{key}.post_attention_layernorm.weight"] = np.ones(hid, np.float32)
    w["model.norm.weight"] = np.ones(hid, np.float32)
    w["lm_head.weight"] = normal(int(cfg["vocab_size"]), hid)
    return w
