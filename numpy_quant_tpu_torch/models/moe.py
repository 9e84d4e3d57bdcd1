"""Mixtral-style sparse-MoE causal decoder ONNX graphs, built from numpy
weights.

Port of ``numpy_quant_tpu/models/moe.py``: the LLaMA block (RMSNorm +
RoPE + GQA, emitted by ``models/llama.py``) with the dense MLP swapped for
a top-k-routed mixture of SwiGLU experts, node for node, from a state dict
in HuggingFace's ``MixtralForCausalLM`` key names
(``model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight``, ...).
Routing is pure graph ops -- Softmax over the router logits, TopK,
renormalize, OneHot -> per-expert weights -- and dispatch is DENSE: every
expert runs on every token and the unselected ones are multiplied by
exactly 0.0, which equals HF's sparse index_add dispatch.
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder
from . import llama as L

# mistralai/Mixtral-8x7B-v0.1 (huggingface.co/mistralai/
# Mixtral-8x7B-v0.1/config.json): 32 layers of 8 SwiGLU experts, top-2
# routing, grouped-query attention (32 heads, 8 KV heads, head dim 128)
MIXTRAL_8X7B = {
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-5, "rope_theta": 1e6, "initializer_range": 0.02,
    "tie_word_embeddings": False,
}


def default_config(seq_len: int = 16) -> dict:
    """The tiny Mixtral of the JAX package's tests (HF MixtralConfig's
    defaults otherwise): 2 layers, hidden 32, 4 heads, 2 KV heads, 4
    experts, top-2, vocabulary 96."""
    return dict(MIXTRAL_8X7B, vocab_size=96, hidden_size=32,
                intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                num_local_experts=4, num_experts_per_tok=2,
                max_position_embeddings=seq_len)


def _cfg(config: dict) -> dict:
    return L._cfg(dict(MIXTRAL_8X7B, **config))


def _expert_swiglu(g: GraphBuilder, w: dict, x: str, key: str,
                   name: str) -> str:
    """MixtralBlockSparseTop2MLP: w2(silu(w1(x)) * w3(x)), all bias-free
    Linears."""
    gate = L._matmul_w(g, x, w[f"{key}.w1.weight"], f"{name}.w1")
    sig = g.node("Sigmoid", [gate], out=f"{name}/Sigmoid_out")
    silu = g.node("Mul", [gate, sig], out=f"{name}/SiLU_out")
    up = L._matmul_w(g, x, w[f"{key}.w3.weight"], f"{name}.w3")
    h = g.node("Mul", [silu, up], out=f"{name}/Gate_out")
    return L._matmul_w(g, h, w[f"{key}.w2.weight"], f"{name}.w2")


def _moe_block(g: GraphBuilder, w: dict, x: str, cfg: dict, key: str,
               name: str) -> str:
    """MixtralSparseMoeBlock as dense graph ops: router softmax over ALL
    experts, TopK, renormalize among the selected, OneHot -> [*, E]
    per-expert weights, weighted sum of every expert's output."""
    n_exp = int(cfg["num_local_experts"])
    top_k = int(cfg["num_experts_per_tok"])
    rw = g.init(f"{name}.gate.weight_t",
                np.ascontiguousarray(L._f32(w[f"{key}.gate.weight"]).T))
    logits = g.node("MatMul", [x, rw], out=f"{name}/router_logits")
    probs = g.node("Softmax", [logits], out=f"{name}/router_probs", axis=-1)
    kc = g.const(np.array([top_k], dtype=np.int64), "moe_k")
    topv, topi = g.node("TopK", [probs, kc], out=f"{name}/TopK",
                        n_outputs=2, axis=-1)
    ssum = g.node("ReduceSum", [topv], out=f"{name}/top_sum", axes=[-1],
                  keepdims=1)
    norm = g.node("Div", [topv, ssum], out=f"{name}/top_norm")

    depth = g.const(np.array(n_exp, dtype=np.int64), "moe_depth")
    onoff = g.const(np.array([0.0, 1.0], dtype=np.float32), "moe_onoff")
    oh = g.node("OneHot", [topi, depth, onoff], out=f"{name}/onehot",
                axis=-1)                                  # [*, k, E]
    ax_last = g.const(np.array([-1], dtype=np.int64), "moe_last_axis")
    normu = g.node("Unsqueeze", [norm, ax_last], out=f"{name}/norm_u")
    wmask = g.node("Mul", [oh, normu], out=f"{name}/weighted_mask")
    # sum over the k slots -> per-expert weight [*, E]
    ew = g.node("ReduceSum", [wmask], out=f"{name}/expert_w", axes=[-2],
                keepdims=0)

    acc = None
    for ei in range(n_exp):
        y = _expert_swiglu(g, w, x, f"{key}.experts.{ei}",
                           f"{name}.experts.{ei}")
        s0 = g.const(np.array([ei], dtype=np.int64), "moe_s0")
        s1 = g.const(np.array([ei + 1], dtype=np.int64), "moe_s1")
        we = g.node("Slice", [ew, s0, s1, ax_last],
                    out=f"{name}/w_{ei}")                 # [*, 1]
        term = g.node("Mul", [y, we], out=f"{name}/scaled_{ei}")
        acc = term if acc is None else \
            g.node("Add", [acc, term], out=f"{name}/acc_{ei}")
    return acc


def _block(g: GraphBuilder, w: dict, h: str, cfg: dict, i: int, attend):
    """One decoder layer: pre-RMSNorm attention (``attend(ln1, key, name)``
    -> output, extra) + residual, pre-RMSNorm expert mixture + residual."""
    key, name = f"model.layers.{i}", f"layers.{i}"
    eps = float(cfg["rms_norm_eps"])
    ln1 = L._rms_norm(g, h, w[f"{key}.input_layernorm.weight"], eps,
                      f"{name}.input_norm")
    att, extra = attend(ln1, f"{key}.self_attn", f"{name}.self_attn")
    x1 = g.node("Add", [att, h], out=f"{name}/residual1")
    ln2 = L._rms_norm(g, x1, w[f"{key}.post_attention_layernorm.weight"],
                      eps, f"{name}.post_norm")
    moe = _moe_block(g, w, ln2, cfg, f"{key}.block_sparse_moe",
                     f"{name}.moe")
    return g.node("Add", [moe, x1], out=f"{name}/residual2"), extra


def mixtral_causal_lm(weights: dict, config: dict, batch_size: int = 2,
                      seq_len: int = 16) -> O.ModelProto:
    """MixtralForCausalLM over float ``inputs_embeds`` [batch, seq, hidden]
    -> ``logits`` [batch, seq, vocab]; ``_wte`` rides on the proto."""
    cfg = _cfg(config)
    g = GraphBuilder("mixtral_causal_lm")
    h = g.input("inputs_embeds", [batch_size, seq_len,
                                  int(cfg["hidden_size"])])
    cos_np, sin_np = L.rope_tables(cfg, seq_len)
    cos = g.init("rope.cos", cos_np)
    sin = g.init("rope.sin", sin_np)

    def attend(x, key, name):
        return L._llama_attention(g, weights, x, cfg, key, seq_len, cos, sin,
                                  name), None

    for i in range(int(cfg["num_hidden_layers"])):
        h, _ = _block(g, weights, h, cfg, i, attend)
    L._lm_head(g, weights, h, cfg)
    g.output("logits", [batch_size, seq_len, int(cfg["vocab_size"])])
    model = g.model()
    model._wte = L._f32(weights["model.embed_tokens.weight"])
    return model


def mixtral_decode_step(weights: dict, config: dict, batch_size: int = 2,
                        max_len: int = 16) -> O.ModelProto:
    """The KV-cache decode form of :func:`mixtral_causal_lm` (one token per
    call): ``llama_decode_step``'s input contract (x_step, attn_mask,
    cos_step/sin_step, per-layer past_k/past_v) with the routed expert
    mixture as the MLP. Drive it with
    ``utils.generate_kv(..., rope=proto._rope_tables, wpe=None)``."""
    cfg = _cfg(config)
    n_kv, head_dim = int(cfg["num_key_value_heads"]), int(cfg["head_dim"])
    layers = int(cfg["num_hidden_layers"])
    g = GraphBuilder("mixtral_decode_step")
    h = g.input("x_step", [batch_size, 1, int(cfg["hidden_size"])])
    g.input("attn_mask", [1, 1, 1, max_len + 1])
    g.input("cos_step", [1, 1, 1, head_dim])
    g.input("sin_step", [1, 1, 1, head_dim])
    for i in range(layers):
        g.input(f"past_k.{i}", [batch_size, n_kv, max_len, head_dim])
        g.input(f"past_v.{i}", [batch_size, n_kv, max_len, head_dim])

    presents = []
    for i in range(layers):
        def attend(x, key, name, i=i):
            att, kh, vh = L._llama_decode_attention(g, weights, x, cfg, key,
                                                    i, max_len, name)
            return att, (kh, vh)
        h, kv = _block(g, weights, h, cfg, i, attend)
        presents.append(kv)
    L._lm_head(g, weights, h, cfg)
    g.output("logits", [batch_size, 1, int(cfg["vocab_size"])])
    L._present_outputs(g, presents, [batch_size, n_kv, 1, head_dim])
    model = g.model()
    model._wte = L._f32(weights["model.embed_tokens.weight"])
    model._rope_tables = L.rope_tables(cfg, max_len)
    return model


def random_mixtral_weights(config: dict, seed: int = 0,
                           num_layers: int | None = None,
                           device: str = "cpu") -> dict[str, np.ndarray]:
    """A MixtralForCausalLM state dict drawn like HF's init: normal(0,
    ``initializer_range``) for the embedding, every projection, the router,
    the experts and the LM head, RMSNorm weights 1. ``num_layers`` draws
    the first layers only (a depth-cut model: pass the same count as
    ``num_hidden_layers`` to the builders). The normals come from a torch
    generator seeded ``seed`` on ``device`` (one 8x7B layer holds 1.4 B
    expert weights: a CUDA generator draws them in milliseconds), so the
    values depend on the device type; they return as host arrays. Each
    Linear weight is drawn [in, out] and returned as its transpose (HF's
    [out, in] shape), so the builders' transposes to the MatMul layout
    copy nothing."""
    import torch

    cfg = _cfg(config)
    layers = int(cfg["num_hidden_layers"]) if num_layers is None \
        else int(num_layers)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    std = float(cfg["initializer_range"])
    hid, inter = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    hd = int(cfg["head_dim"])
    q_out = int(cfg["num_attention_heads"]) * hd
    kv_out = int(cfg["num_key_value_heads"]) * hd
    n_exp = int(cfg["num_local_experts"])

    def draw(*shape):
        t = torch.randn(shape, generator=gen, device=device)
        return t.mul_(std).cpu().numpy()

    def normal(n_out, n_in):
        return draw(n_in, n_out).T

    w = {"model.embed_tokens.weight": draw(int(cfg["vocab_size"]), hid)}
    for i in range(layers):
        key = f"model.layers.{i}"
        for proj, (n_out, n_in) in (("q_proj", (q_out, hid)),
                                    ("k_proj", (kv_out, hid)),
                                    ("v_proj", (kv_out, hid)),
                                    ("o_proj", (hid, q_out))):
            w[f"{key}.self_attn.{proj}.weight"] = normal(n_out, n_in)
        moe = f"{key}.block_sparse_moe"
        w[f"{moe}.gate.weight"] = normal(n_exp, hid)
        for e in range(n_exp):
            w[f"{moe}.experts.{e}.w1.weight"] = normal(inter, hid)
            w[f"{moe}.experts.{e}.w2.weight"] = normal(hid, inter)
            w[f"{moe}.experts.{e}.w3.weight"] = normal(inter, hid)
        w[f"{key}.input_layernorm.weight"] = np.ones(hid, np.float32)
        w[f"{key}.post_attention_layernorm.weight"] = np.ones(hid, np.float32)
    w["model.norm.weight"] = np.ones(hid, np.float32)
    w["lm_head.weight"] = normal(int(cfg["vocab_size"]), hid)
    return w
