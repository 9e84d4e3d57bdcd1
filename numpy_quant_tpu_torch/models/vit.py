"""ViT image-classifier ONNX graph, built from numpy weights.

Port of ``numpy_quant_tpu/models/vit.py::vit_image_classifier``: the same
nodes, value names and attributes, emitted from a state dict in
HuggingFace's ``ViTForImageClassification`` key names instead of a live
``transformers`` module:

* Linear on 3D activations -> MatMul(pre-transposed weight) + Add(bias)
* Linear on 2D activations -> Gemm(transB=1)
* exact GELU               -> Div/Erf/Add/Mul/Mul chain
* LayerNorm                -> opset-17 LayerNormalization
* attention head split     -> Shape/Gather/Unsqueeze/Concat -> Reshape
                              -> Transpose chains (dynamic batch dim)
* cls-token broadcast      -> Equal/Where/Expand on the shape domain
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder

# ViT-Base-patch16-224 with a 1000-class head (HF ViTConfig defaults)
VIT_BASE = {
    "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
    "intermediate_size": 3072, "image_size": 224, "patch_size": 16,
    "num_channels": 3, "num_labels": 1000, "layer_norm_eps": 1e-12,
}


# quantize() options of the served configurations: int8 weights and
# activations, W4A8 per-channel (bench.py's NQ_TPU_BENCH_MODE=w4a8), W3A8,
# whose odd width packs as bit-planes, and W8A16
WEIGHT_CONFIGS = {
    "int8": dict(bit_width=8),
    "w4a8": dict(bit_width=8, weight_bit_width=4, per_channel_weights=True),
    "w3a8": dict(bit_width=8, weight_bit_width=3),
    # 16-bit activations, 8-bit weights: the x64-mode integer path. f32
    # only: a 16-bit grid over bf16 values is meaningless.
    "w8a16": dict(bit_width=16, weight_bit_width=8)}


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _key(prefix: str, name: str) -> str:
    """A state-dict key under ``prefix`` ("" for the module's own)."""
    return f"{prefix}.{name}" if prefix else name


class _ViTEmitter:
    """Node-emission helpers over a GraphBuilder and a state dict."""

    def __init__(self, g: GraphBuilder, weights: dict, eps: float):
        self.g = g
        self.w = weights
        self.eps = float(eps)

    def linear3d(self, x: str, key: str, name: str) -> str:
        """torch Linear on a 3D tensor: MatMul + Add (exporter pattern)."""
        g = self.g
        w = g.init(f"{name}.weight_t",
                   np.ascontiguousarray(_f32(self.w[_key(key, "weight")]).T))
        y = g.node("MatMul", [x, w], out=f"{name}/MatMul_out")
        b = g.init(f"{name}.bias", _f32(self.w[_key(key, "bias")]))
        return g.node("Add", [y, b], out=f"{name}/Add_out")

    def linear2d(self, x: str, key: str, name: str) -> str:
        """torch Linear on a 2D tensor: Gemm(transB=1)."""
        g = self.g
        w = g.init(f"{name}.weight", _f32(self.w[_key(key, "weight")]))
        b = g.init(f"{name}.bias", _f32(self.w[_key(key, "bias")]))
        return g.node("Gemm", [x, w, b], out=f"{name}/Gemm_out",
                      alpha=1.0, beta=1.0, transB=1)

    def layernorm(self, x: str, key: str, name: str) -> str:
        g = self.g
        scale = g.init(f"{name}.weight", _f32(self.w[_key(key, "weight")]))
        bias = g.init(f"{name}.bias", _f32(self.w[_key(key, "bias")]))
        return g.node("LayerNormalization", [x, scale, bias],
                      out=f"{name}/LayerNorm_out", axis=-1, epsilon=self.eps)

    def gelu(self, x: str, name: str) -> str:
        """Exact erf GELU, as the torch exporter decomposes it."""
        g = self.g
        sqrt2 = g.const(np.array(np.sqrt(2.0), dtype=np.float32), "sqrt2")
        d = g.node("Div", [x, sqrt2], out=f"{name}/Div_out")
        e = g.node("Erf", [d], out=f"{name}/Erf_out")
        one = g.const(np.array(1.0, dtype=np.float32), "one")
        a = g.node("Add", [e, one], out=f"{name}/AddOne_out")
        m = g.node("Mul", [x, a], out=f"{name}/Mul_out")
        half = g.const(np.array(0.5, dtype=np.float32), "half")
        return g.node("Mul", [m, half], out=f"{name}/MulHalf_out")

    def batch_dim(self, x: str, name: str) -> str:
        """Shape(x) -> Gather(0) -> Unsqueeze: the dynamic batch dim."""
        g = self.g
        s = g.node("Shape", [x], out=f"{name}/Shape_out")
        i0 = g.const(np.array(0, dtype=np.int64), "idx0")
        d = g.node("Gather", [s, i0], out=f"{name}/Gather_out", axis=0)
        ax = g.const(np.array([0], dtype=np.int64), "axes0")
        return g.node("Unsqueeze", [d, ax], out=f"{name}/Unsqueeze_out")

    def self_attention(self, x: str, key: str, name: str, num_heads: int,
                       head_size: int) -> str:
        """HF ViTSelfAttention: q/k/v heads, scores*scaling, softmax,
        context; returns the (B, N, H) context."""
        g = self.g
        scaling = np.float32(1.0 / np.sqrt(head_size))
        q = self.linear3d(x, _key(key, "query"), f"{name}.query")
        k = self.linear3d(x, _key(key, "key"), f"{name}.key")
        v = self.linear3d(x, _key(key, "value"), f"{name}.value")

        b_dim = self.batch_dim(x, f"{name}/bdim")
        tail = g.const(np.array([-1, num_heads, head_size], dtype=np.int64),
                       "headshape")
        new_shape = g.node("Concat", [b_dim, tail],
                           out=f"{name}/Concat_shape", axis=0)

        def split_heads(t: str, which: str) -> str:
            r = g.node("Reshape", [t, new_shape], out=f"{name}/{which}_Reshape")
            return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                          perm=[0, 2, 1, 3])

        qh = split_heads(q, "q")
        kh = split_heads(k, "k")
        vh = split_heads(v, "v")
        kt = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
        scores = g.node("MatMul", [qh, kt], out=f"{name}/scores")
        scal = g.const(np.array(scaling, dtype=np.float32), "scaling")
        scaled = g.node("Mul", [scores, scal], out=f"{name}/scaled")
        probs = g.node("Softmax", [scaled], out=f"{name}/probs", axis=-1)
        ctx = g.node("MatMul", [probs, vh], out=f"{name}/context")
        ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                     perm=[0, 2, 1, 3])
        merge_tail = g.const(np.array([-1, num_heads * head_size],
                                      dtype=np.int64), "mergeshape")
        merge_shape = g.node("Concat", [b_dim, merge_tail],
                             out=f"{name}/Concat_merge", axis=0)
        return g.node("Reshape", [ctx, merge_shape], out=f"{name}/merged")

    def encoder_layer(self, x: str, key: str, name: str, num_heads: int,
                      head_size: int) -> str:
        """HF ViTLayer: pre-LN attention + residual, pre-LN MLP + residual."""
        ln1 = self.layernorm(x, _key(key, "layernorm_before"), f"{name}.ln_before")
        ctx = self.self_attention(ln1, _key(key, "attention.attention"),
                                  f"{name}.attention", num_heads, head_size)
        att_out = self.linear3d(ctx, _key(key, "attention.output.dense"),
                                f"{name}.attention.output")
        x1 = self.g.node("Add", [att_out, x], out=f"{name}/residual1")
        ln2 = self.layernorm(x1, _key(key, "layernorm_after"), f"{name}.ln_after")
        inter = self.linear3d(ln2, _key(key, "intermediate.dense"),
                              f"{name}.intermediate")
        act = self.gelu(inter, f"{name}.gelu")
        mlp_out = self.linear3d(act, _key(key, "output.dense"), f"{name}.output")
        return self.g.node("Add", [mlp_out, x1], out=f"{name}/residual2")

    def embeddings(self, x: str, key: str, name: str, hidden: int,
                   patch: int) -> str:
        """HF ViTEmbeddings: patch conv, flatten, cls concat, pos add."""
        g = self.g
        w = g.init(f"{name}.projection.weight",
                   _f32(self.w[_key(key, "patch_embeddings.projection.weight")]))
        b = g.init(f"{name}.projection.bias",
                   _f32(self.w[_key(key, "patch_embeddings.projection.bias")]))
        conv = g.node("Conv", [x, w, b], out=f"{name}/Conv_out",
                      kernel_shape=[patch, patch], pads=[0, 0, 0, 0],
                      strides=[patch, patch])
        # flatten(2) + transpose(1, 2)
        b_dim = self.batch_dim(x, f"{name}/bdim")
        tail = g.const(np.array([hidden, -1], dtype=np.int64), "flatshape")
        flat_shape = g.node("Concat", [b_dim, tail],
                            out=f"{name}/Concat_flat", axis=0)
        flat = g.node("Reshape", [conv, flat_shape], out=f"{name}/flat")
        patches = g.node("Transpose", [flat], out=f"{name}/patches",
                         perm=[0, 2, 1])
        # cls token: expand (B, 1, H) via the torch Expand lowering
        cls = g.init(f"{name}.cls_token", _f32(self.w[_key(key, "cls_token")]))
        minus1 = g.const(np.array([-1, -1], dtype=np.int64), "minus1")
        target = g.node("Concat", [b_dim, minus1],
                        out=f"{name}/Concat_target", axis=0)
        m1 = g.const(np.array([-1], dtype=np.int64), "m1")
        mask = g.node("Equal", [target, m1], out=f"{name}/Equal_out")
        cls_shape = g.node("Shape", [cls], out=f"{name}/cls_shape")
        resolved = g.node("Where", [mask, cls_shape, target],
                          out=f"{name}/Where_out")
        cls_exp = g.node("Expand", [cls, resolved], out=f"{name}/cls_expand")
        tokens = g.node("Concat", [cls_exp, patches],
                        out=f"{name}/tokens", axis=1)
        pos = g.init(f"{name}.position_embeddings",
                     _f32(self.w[_key(key, "position_embeddings")]))
        return g.node("Add", [tokens, pos], out=f"{name}/embeddings")

    def pooler(self, x: str, key: str, name: str) -> str:
        """HF ViTPooler: dense + tanh on the CLS token."""
        g = self.g
        i0 = g.const(np.array(0, dtype=np.int64), "idx0")
        cls = g.node("Gather", [x, i0], out=f"{name}/cls", axis=1)
        dense = self.linear2d(cls, _key(key, "dense"), f"{name}.dense")
        return g.node("Tanh", [dense], out=f"{name}/Tanh_out")


# ---------------------------------------------------------------------------
# The sub-graph generators (the JAX package's vit_self_attention,
# vit_embedding, vit_layer, vit_pooler and vit; the reference's
# models/test.py generators): the same parameters, the weights an HF-keyed
# state dict of the sub-module (``weights=None``: vit_part_weights' seeded
# draw)
# ---------------------------------------------------------------------------

def _finish(g: GraphBuilder, y: str, name: str, shape: list) -> O.ModelProto:
    g.node("Identity", [y], out=name, name="out_identity")
    g.output(name, shape)
    return g.model()


def vit_self_attention(batch_size: int, embeddings_size: int,
                       hidden_size: int, num_attention_heads: int,
                       seed: int = 0, weights: dict | None = None
                       ) -> O.ModelProto:
    """HF ViTSelfAttention: ``weights`` keyed ``query.weight`` ..."""
    cfg = dict(hidden_size=hidden_size,
               num_attention_heads=num_attention_heads)
    w = vit_part_weights("self_attention", cfg, seed) if weights is None \
        else weights
    g = GraphBuilder("vit_self_attention")
    e = _ViTEmitter(g, w, VIT_BASE["layer_norm_eps"])
    shape = [batch_size, embeddings_size, hidden_size]
    x = g.input("input_states", shape)
    ctx = e.self_attention(x, "", "attn", num_attention_heads,
                           hidden_size // num_attention_heads)
    return _finish(g, ctx, "output_states", shape)


def vit_embedding(batch_size: int, image_size: int, patch_size: int,
                  hidden_size: int, seed: int = 0,
                  weights: dict | None = None) -> O.ModelProto:
    """HF ViTEmbeddings: ``weights`` keyed ``cls_token``,
    ``position_embeddings``, ``patch_embeddings.projection.*``."""
    cfg = dict(image_size=image_size, patch_size=patch_size,
               hidden_size=hidden_size)
    w = vit_part_weights("embeddings", cfg, seed) if weights is None \
        else weights
    g = GraphBuilder("vit_embedding")
    e = _ViTEmitter(g, w, VIT_BASE["layer_norm_eps"])
    x = g.input("inputs", [batch_size, 3, image_size, image_size])
    emb = e.embeddings(x, "", "embeddings", hidden_size, patch_size)
    n_tokens = (image_size // patch_size) ** 2 + 1
    return _finish(g, emb, "hidden_states",
                   [batch_size, n_tokens, hidden_size])


def vit_layer(batch_size: int, image_size: int, patch_size: int,
              intermediate_size: int, hidden_size: int,
              num_attention_heads: int, seed: int = 0,
              weights: dict | None = None) -> O.ModelProto:
    """HF ViTLayer: ``weights`` keyed ``attention.attention.query.weight``
    ... ``layernorm_after.bias``."""
    cfg = dict(image_size=image_size, patch_size=patch_size,
               hidden_size=hidden_size,
               num_attention_heads=num_attention_heads,
               intermediate_size=intermediate_size)
    w = vit_part_weights("layer", cfg, seed) if weights is None else weights
    g = GraphBuilder("vit_layer")
    e = _ViTEmitter(g, w, VIT_BASE["layer_norm_eps"])
    shape = [batch_size, (image_size // patch_size) ** 2 + 1, hidden_size]
    x = g.input("inputs", shape)
    y = e.encoder_layer(x, "", "layer", num_attention_heads,
                        hidden_size // num_attention_heads)
    return _finish(g, y, "hidden_states", shape)


def vit_pooler(batch_size: int, image_size: int, patch_size: int,
               hidden_size: int, seed: int = 0,
               weights: dict | None = None) -> O.ModelProto:
    """HF ViTPooler: ``weights`` keyed ``dense.weight``, ``dense.bias``."""
    cfg = dict(image_size=image_size, patch_size=patch_size,
               hidden_size=hidden_size)
    w = vit_part_weights("pooler", cfg, seed) if weights is None \
        else weights
    g = GraphBuilder("vit_pooler")
    e = _ViTEmitter(g, w, VIT_BASE["layer_norm_eps"])
    n_tokens = (image_size // patch_size) ** 2 + 1
    x = g.input("inputs", [batch_size, n_tokens, hidden_size])
    y = e.pooler(x, "", "pooler")
    return _finish(g, y, "pooler_output", [batch_size, hidden_size])


def vit(batch_size: int, image_size: int, patch_size: int,
        intermediate_size: int, hidden_size: int, num_attention_heads: int,
        num_hidden_layers: int = 2, seed: int = 0,
        weights: dict | None = None) -> O.ModelProto:
    """HF ViTModel without its pooler (embeddings, encoder, final
    LayerNorm): ``weights`` keyed ``embeddings.*``, ``encoder.layer.{i}.*``,
    ``layernorm.*``."""
    cfg = dict(image_size=image_size, patch_size=patch_size,
               hidden_size=hidden_size,
               num_attention_heads=num_attention_heads,
               intermediate_size=intermediate_size,
               num_hidden_layers=num_hidden_layers)
    w = vit_part_weights("vit", cfg, seed) if weights is None else weights
    g = GraphBuilder("vit")
    e = _ViTEmitter(g, w, VIT_BASE["layer_norm_eps"])
    x = g.input("inputs", [batch_size, 3, image_size, image_size])
    h = e.embeddings(x, "embeddings", "embeddings", hidden_size, patch_size)
    for i in range(num_hidden_layers):
        h = e.encoder_layer(h, f"encoder.layer.{i}", f"encoder.layer.{i}",
                            num_attention_heads,
                            hidden_size // num_attention_heads)
    h = e.layernorm(h, "layernorm", "layernorm")
    n_tokens = (image_size // patch_size) ** 2 + 1
    return _finish(g, h, "hidden_states", [batch_size, n_tokens, hidden_size])


def vit_image_classifier(weights: dict, config: dict,
                         batch_size: int | None = None) -> O.ModelProto:
    """Full ViTForImageClassification graph from ``weights`` (HF state
    dict key names, numpy arrays) and ``config`` (HF ViTConfig field
    names, e.g. ``VIT_BASE``). ``batch_size=None`` exports a dynamic
    batch axis 'B'."""
    cfg = dict(VIT_BASE, **config)
    hidden = int(cfg["hidden_size"])
    heads = int(cfg["num_attention_heads"])
    g = GraphBuilder("vit_image_classifier")
    e = _ViTEmitter(g, weights, cfg["layer_norm_eps"])
    b = "B" if batch_size is None else batch_size
    size = int(cfg["image_size"])
    x = g.input("inputs", [b, int(cfg["num_channels"]), size, size])
    h = e.embeddings(x, "vit.embeddings", "embeddings", hidden,
                     int(cfg["patch_size"]))
    for i in range(int(cfg["num_hidden_layers"])):
        h = e.encoder_layer(h, f"vit.encoder.layer.{i}",
                            f"encoder.layer.{i}", heads, hidden // heads)
    h = e.layernorm(h, "vit.layernorm", "layernorm")
    # classifier on the CLS token: Gather(axis=1, 0) -> Gemm
    i0 = g.const(np.array(0, dtype=np.int64), "idx0")
    cls = g.node("Gather", [h, i0], out="/cls_token_out", axis=1)
    logits = e.linear2d(cls, "classifier", "classifier")
    g.node("Identity", [logits], out="logits", name="out_identity")
    g.output("logits", [b, int(cfg["num_labels"])])
    return g.model()


def _trunc_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """normal(0, std) truncated at +-2 std (out-of-range draws redrawn)."""
    out = rng.normal(0.0, std, size=shape)
    bad = np.abs(out) > 2 * std
    while bad.any():
        out[bad] = rng.normal(0.0, std, size=int(bad.sum()))
        bad = np.abs(out) > 2 * std
    return out.astype(np.float32)


def random_vit_weights(config: dict, seed: int = 0,
                       std: float = 0.02) -> dict[str, np.ndarray]:
    """A ViTForImageClassification state dict drawn like HF's init:
    truncated normal(0, 0.02) for weights and the cls/position
    embeddings, zero biases, LayerNorm weight 1 and bias 0."""
    cfg = dict(VIT_BASE, **config)
    rng = np.random.default_rng(seed)
    hid = int(cfg["hidden_size"])
    inter = int(cfg["intermediate_size"])
    p = int(cfg["patch_size"])
    ch = int(cfg["num_channels"])
    n_tok = (int(cfg["image_size"]) // p) ** 2 + 1
    w: dict[str, np.ndarray] = {}

    def linear(key, n_out, n_in):
        w[f"{key}.weight"] = _trunc_normal(rng, (n_out, n_in), std)
        w[f"{key}.bias"] = np.zeros(n_out, np.float32)

    def layernorm(key):
        w[f"{key}.weight"] = np.ones(hid, np.float32)
        w[f"{key}.bias"] = np.zeros(hid, np.float32)

    w["vit.embeddings.cls_token"] = _trunc_normal(rng, (1, 1, hid), std)
    w["vit.embeddings.position_embeddings"] = _trunc_normal(
        rng, (1, n_tok, hid), std)
    w["vit.embeddings.patch_embeddings.projection.weight"] = _trunc_normal(
        rng, (hid, ch, p, p), std)
    w["vit.embeddings.patch_embeddings.projection.bias"] = \
        np.zeros(hid, np.float32)
    for i in range(int(cfg["num_hidden_layers"])):
        key = f"vit.encoder.layer.{i}"
        for part in ("query", "key", "value"):
            linear(f"{key}.attention.attention.{part}", hid, hid)
        linear(_key(key, "attention.output.dense"), hid, hid)
        linear(_key(key, "intermediate.dense"), inter, hid)
        linear(_key(key, "output.dense"), hid, inter)
        layernorm(_key(key, "layernorm_before"))
        layernorm(_key(key, "layernorm_after"))
    layernorm("vit.layernorm")
    linear("classifier", int(cfg["num_labels"]), hid)
    return w


# the classifier's state-dict prefix of each sub-module vit_part_weights
# draws
_PARTS = {"vit": "vit.", "embeddings": "vit.embeddings.",
          "layer": "vit.encoder.layer.0.",
          "self_attention": "vit.encoder.layer.0.attention.attention."}


def vit_part_weights(part: str, config: dict, seed: int = 0,
                     std: float = 0.02) -> dict[str, np.ndarray]:
    """A seeded HF state dict of one sub-module -- ``part`` is
    "self_attention", "embeddings", "layer", "pooler" or "vit" -- drawn as
    :func:`random_vit_weights` draws the classifier's (the pooler's dense
    layer likewise), keyed as the sub-module's own ``state_dict()``."""
    if part == "pooler":
        hid = int(dict(VIT_BASE, **config)["hidden_size"])
        rng = np.random.default_rng(seed)
        return {"dense.weight": _trunc_normal(rng, (hid, hid), std),
                "dense.bias": np.zeros(hid, np.float32)}
    prefix = _PARTS[part]
    cfg = dict(config) if part == "vit" else dict(config, num_hidden_layers=1)
    full = random_vit_weights(cfg, seed=seed, std=std)
    return {k[len(prefix):]: v for k, v in full.items()
            if k.startswith(prefix)}
