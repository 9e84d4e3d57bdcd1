"""GPT-2 causal decoder ONNX graphs, built from numpy weights.

Port of ``numpy_quant_tpu/models/gpt.py::gpt_causal_lm`` and
``::gpt_decode_step``: the same nodes, value names, attributes, inputs and
outputs, emitted from a state dict in HuggingFace's ``GPT2LMHeadModel``
key names (``transformer.h.{i}.attn.c_attn.weight``, ...) instead of a
live ``transformers`` module:

* GPT-2 Conv1D        -> MatMul(W as stored, [in, out]) + Add(bias); the
                         weight is NOT transposed (unlike torch Linear)
* merged q/k/v        -> Split(num_outputs=3) of the c_attn output
* exact GELU          -> Div/Erf/Add/Mul/Mul chain
* LayerNorm           -> opset-17 LayerNormalization
* LM head             -> MatMul with wte^T (weight-tied to the embedding)

The graphs take embeddings, not ids: token and position embedding
happen outside (utils/generate.py), from the tables that ride on the
returned proto as ``_wte`` [vocab, hidden] and ``_wpe`` [n_pos, hidden].
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder
from .vit import _ViTEmitter, _f32

# GPT-2 small (HF GPT2Config defaults) with the exact-erf GELU the graph
# emits (the JAX builder requires activation_function == "gelu")
GPT2_SMALL = {
    "vocab_size": 50257, "n_positions": 1024, "n_embd": 768, "n_layer": 12,
    "n_head": 12, "layer_norm_epsilon": 1e-5, "activation_function": "gelu",
}


def _cfg(config: dict) -> dict:
    cfg = dict(GPT2_SMALL, **config)
    if cfg["activation_function"] != "gelu":
        raise ValueError("the GPT graphs emit the exact-erf GELU; "
                         f"activation_function {cfg['activation_function']!r} "
                         "is not built")
    return cfg


def _conv1d(e: _ViTEmitter, x: str, key: str, name: str) -> str:
    """GPT-2 Conv1D: y = x @ W + b with W stored [in, out]."""
    g = e.g
    w = g.init(f"{name}.weight", _f32(e.w[f"{key}.weight"]))
    y = g.node("MatMul", [x, w], out=f"{name}/MatMul_out")
    b = g.init(f"{name}.bias", _f32(e.w[f"{key}.bias"]))
    return g.node("Add", [y, b], out=f"{name}/Add_out")


def _qkv_heads(e: _ViTEmitter, x: str, key: str, name: str, nh: int,
               hd: int):
    """c_attn -> Split(q, k, v) -> per-head [B, heads, T, head] tensors;
    returns (qh, kh, vh, batch dim)."""
    g = e.g
    qkv = _conv1d(e, x, f"{key}.c_attn", f"{name}.c_attn")
    q, k, v = g.node("Split", [qkv], out=f"{name}/qkv_split", n_outputs=3,
                     axis=-1, num_outputs=3)
    b_dim = e.batch_dim(x, f"{name}/bdim")
    tail = g.const(np.array([-1, nh, hd], dtype=np.int64), "headshape")
    new_shape = g.node("Concat", [b_dim, tail], out=f"{name}/Concat_shape",
                       axis=0)

    def split_heads(t: str, which: str) -> str:
        r = g.node("Reshape", [t, new_shape], out=f"{name}/{which}_Reshape")
        return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                      perm=[0, 2, 1, 3])

    return (split_heads(q, "q"), split_heads(k, "k"), split_heads(v, "v"),
            b_dim)


def _merge_heads(e: _ViTEmitter, ctx: str, b_dim: str, key: str, name: str,
                 nh: int, hd: int) -> str:
    g = e.g
    ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                 perm=[0, 2, 1, 3])
    merge_tail = g.const(np.array([-1, nh * hd], dtype=np.int64),
                         "mergeshape")
    merge_shape = g.node("Concat", [b_dim, merge_tail],
                         out=f"{name}/Concat_merge", axis=0)
    merged = g.node("Reshape", [ctx, merge_shape], out=f"{name}/merged")
    return _conv1d(e, merged, f"{key}.c_proj", f"{name}.c_proj")


def _causal_attention(e: _ViTEmitter, x: str, key: str, seq_len: int,
                      name: str, nh: int, hd: int) -> str:
    """GPT2Attention over the whole sequence: scaled scores + the additive
    causal mask constant -> softmax -> context -> c_proj."""
    g = e.g
    qh, kh, vh, b_dim = _qkv_heads(e, x, key, name, nh, hd)
    kt = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
    scores = g.node("MatMul", [qh, kt], out=f"{name}/scores")
    scal = g.const(np.array(np.float32(1.0 / np.sqrt(hd)), dtype=np.float32),
                   "scaling")
    scaled = g.node("Mul", [scores, scal], out=f"{name}/scaled")
    mask = np.triu(np.full((seq_len, seq_len), np.float32(-1e9)), k=1)
    mc = g.init(f"{name}.causal_mask", mask[None, None].astype(np.float32))
    masked = g.node("Add", [scaled, mc], out=f"{name}/masked")
    probs = g.node("Softmax", [masked], out=f"{name}/probs", axis=-1)
    ctx = g.node("MatMul", [probs, vh], out=f"{name}/context")
    return _merge_heads(e, ctx, b_dim, key, name, nh, hd)


def _mlp(e: _ViTEmitter, x: str, key: str, name: str) -> str:
    fc = _conv1d(e, x, f"{key}.mlp.c_fc", f"{name}.mlp.c_fc")
    act = e.gelu(fc, f"{name}.mlp.gelu")
    return _conv1d(e, act, f"{key}.mlp.c_proj", f"{name}.mlp.c_proj")


def _lm_head(e: _ViTEmitter, h: str) -> None:
    """ln_f, then the weight-tied head: logits = h @ wte^T."""
    h = e.layernorm(h, "transformer.ln_f", "ln_f")
    head = e.g.init("lm_head.weight_t", np.ascontiguousarray(
        _f32(e.w["transformer.wte.weight"]).T))
    e.g.node("MatMul", [h, head], out="logits", name="lm_head")


def _finish(g: GraphBuilder, weights: dict) -> O.ModelProto:
    model = g.model()
    model._wte = _f32(weights["transformer.wte.weight"])  # [vocab, hidden]
    model._wpe = _f32(weights["transformer.wpe.weight"])  # [n_pos, hidden]
    return model


def gpt_causal_lm(weights: dict, config: dict, batch_size: int = 2,
                  seq_len: int = 16) -> O.ModelProto:
    """GPT2LMHeadModel over float ``inputs_embeds`` [batch, seq, hidden]
    -> ``logits`` [batch, seq, vocab]; position embeddings add inside the
    graph, token embedding happens outside."""
    cfg = _cfg(config)
    nh = int(cfg["n_head"])
    hd = int(cfg["n_embd"]) // nh
    g = GraphBuilder("gpt_causal_lm")
    e = _ViTEmitter(g, weights, cfg["layer_norm_epsilon"])
    x = g.input("inputs_embeds", [batch_size, seq_len, int(cfg["n_embd"])])
    wpe = g.init("wpe.slice", _f32(weights["transformer.wpe.weight"])[:seq_len])
    h = g.node("Add", [x, wpe], out="/pos_add")
    for i in range(int(cfg["n_layer"])):
        key, name = f"transformer.h.{i}", f"h.{i}"
        ln1 = e.layernorm(h, f"{key}.ln_1", f"{name}.ln_1")
        att = _causal_attention(e, ln1, f"{key}.attn", seq_len,
                                f"{name}.attn", nh, hd)
        x1 = g.node("Add", [att, h], out=f"{name}/residual1")
        ln2 = e.layernorm(x1, f"{key}.ln_2", f"{name}.ln_2")
        h = g.node("Add", [_mlp(e, ln2, key, name), x1],
                   out=f"{name}/residual2")
    _lm_head(e, h)
    g.output("logits", [batch_size, seq_len, int(cfg["vocab_size"])])
    return _finish(g, weights)


def _decode_attention(e: _ViTEmitter, x: str, key: str, layer: int,
                      max_len: int, name: str, nh: int, hd: int):
    """One-token attention against a fixed-length cache: scores over
    [cache | current] (L+1 lanes), the additive ``attn_mask`` input
    invalidates the cache tail, and the probabilities split back into a
    cache product plus a self term. Returns (c_proj output, k, v)."""
    g = e.g
    qh, kh, vh, b_dim = _qkv_heads(e, x, key, name, nh, hd)
    kt_cache = g.node("Transpose", [f"past_k.{layer}"],
                      out=f"{name}/cache_k_T", perm=[0, 1, 3, 2])
    s_past = g.node("MatMul", [qh, kt_cache], out=f"{name}/scores_past")
    kt_step = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
    s_self = g.node("MatMul", [qh, kt_step], out=f"{name}/scores_self")
    s = g.node("Concat", [s_past, s_self], out=f"{name}/scores", axis=-1)
    scal = g.const(np.array(np.float32(1.0 / np.sqrt(hd)), dtype=np.float32),
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
    ctx = g.node("MatMul", [p_past, f"past_v.{layer}"],
                 out=f"{name}/ctx_past")
    self_ctx = g.node("Mul", [p_self, vh], out=f"{name}/ctx_self")
    ctx = g.node("Add", [ctx, self_ctx], out=f"{name}/context")
    return _merge_heads(e, ctx, b_dim, key, name, nh, hd), kh, vh


def gpt_decode_step(weights: dict, config: dict, batch_size: int = 2,
                    max_len: int = 16) -> O.ModelProto:
    """The KV-cache decode form of :func:`gpt_causal_lm`: one token per
    call against caches of ``max_len`` slots.

    Inputs, in order: ``x_step`` [B, 1, H] (wte + wpe added by the
    caller), ``attn_mask`` [1, 1, 1, L+1] additive (-1e9 on cache slots
    >= t, 0 elsewhere; the last lane, the current token, always live),
    then ``past_k.i``/``past_v.i`` [B, heads, L, head] per layer.
    Outputs: ``logits`` [B, 1, V], then ``present_k.i``/``present_v.i``
    [B, heads, 1, head] per layer, which the caller writes into its
    caches at position t (utils/generate.py::generate_kv)."""
    cfg = _cfg(config)
    nh = int(cfg["n_head"])
    hd = int(cfg["n_embd"]) // nh
    g = GraphBuilder("gpt_decode_step")
    e = _ViTEmitter(g, weights, cfg["layer_norm_epsilon"])
    h = g.input("x_step", [batch_size, 1, int(cfg["n_embd"])])
    g.input("attn_mask", [1, 1, 1, max_len + 1])
    for i in range(int(cfg["n_layer"])):
        g.input(f"past_k.{i}", [batch_size, nh, max_len, hd])
        g.input(f"past_v.{i}", [batch_size, nh, max_len, hd])
    presents = []
    for i in range(int(cfg["n_layer"])):
        key, name = f"transformer.h.{i}", f"h.{i}"
        ln1 = e.layernorm(h, f"{key}.ln_1", f"{name}.ln_1")
        att, kh, vh = _decode_attention(e, ln1, f"{key}.attn", i, max_len,
                                        f"{name}.attn", nh, hd)
        presents.append((kh, vh))
        x1 = g.node("Add", [att, h], out=f"{name}/residual1")
        ln2 = e.layernorm(x1, f"{key}.ln_2", f"{name}.ln_2")
        h = g.node("Add", [_mlp(e, ln2, key, name), x1],
                   out=f"{name}/residual2")
    _lm_head(e, h)
    g.output("logits", [batch_size, 1, int(cfg["vocab_size"])])
    for i, (kh, vh) in enumerate(presents):
        g.node("Identity", [kh], out=f"present_k.{i}", name=f"present_k_id.{i}")
        g.node("Identity", [vh], out=f"present_v.{i}", name=f"present_v_id.{i}")
        g.output(f"present_k.{i}", [batch_size, nh, 1, hd])
        g.output(f"present_v.{i}", [batch_size, nh, 1, hd])
    return _finish(g, weights)


def random_gpt2_weights(config: dict, seed: int = 0,
                        std: float = 0.02) -> dict[str, np.ndarray]:
    """A GPT2LMHeadModel state dict drawn like HF's init: normal(0, std)
    for the embeddings and Conv1D weights, std / sqrt(2 * n_layer) for the
    two c_proj weights of each block, zero biases, LayerNorm weight 1 and
    bias 0; ``lm_head.weight`` is ``transformer.wte.weight`` (tied)."""
    cfg = _cfg(config)
    rng = np.random.default_rng(seed)
    hid = int(cfg["n_embd"])
    n_layer = int(cfg["n_layer"])
    proj_std = std / np.sqrt(2 * n_layer)
    w: dict[str, np.ndarray] = {}

    def normal(shape, s):
        return rng.normal(0.0, s, size=shape).astype(np.float32)

    def conv1d(key, n_in, n_out, s=std):
        w[f"{key}.weight"] = normal((n_in, n_out), s)
        w[f"{key}.bias"] = np.zeros(n_out, np.float32)

    def layernorm(key):
        w[f"{key}.weight"] = np.ones(hid, np.float32)
        w[f"{key}.bias"] = np.zeros(hid, np.float32)

    w["transformer.wte.weight"] = normal((int(cfg["vocab_size"]), hid), std)
    w["transformer.wpe.weight"] = normal((int(cfg["n_positions"]), hid), std)
    for i in range(n_layer):
        key = f"transformer.h.{i}"
        layernorm(f"{key}.ln_1")
        conv1d(f"{key}.attn.c_attn", hid, 3 * hid)
        conv1d(f"{key}.attn.c_proj", hid, hid, proj_std)
        layernorm(f"{key}.ln_2")
        conv1d(f"{key}.mlp.c_fc", hid, 4 * hid)
        conv1d(f"{key}.mlp.c_proj", 4 * hid, hid, proj_std)
    layernorm("transformer.ln_f")
    w["lm_head.weight"] = w["transformer.wte.weight"]
    return w
