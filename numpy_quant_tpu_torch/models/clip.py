"""CLIP-style dual-encoder (contrastive vision + text) ONNX graph, built
from numpy weights.

Port of ``numpy_quant_tpu/models/clip.py::clip_dual_encoder``: the same
nodes, value names, attributes, inputs and outputs, emitted from a state
dict in HuggingFace's ``CLIPModel`` key names
(``vision_model.encoder.layers.{i}.self_attn.q_proj.weight``, ...) instead
of a live ``transformers`` module. The vision tower is ViT-like (patch
Conv, class token, pre-LN blocks), the text tower causal; both use
QuickGELU MLPs. The projection heads, L2 normalization and the
``exp(logit_scale)``-scaled similarity are in the same graph, so
``logits_per_image`` is one forward over (pixel_values, text embeddings).
The attention emits HF's eager order (scores * scale, + mask, softmax),
the fusion matcher's idiom, so ``optimize()`` fuses both towers.

Pooling contract: the text tower pools its LAST position (T-1); prompts
are padded so that EOS sits there.
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder
from .vit import _f32

# openai/clip-vit-base-patch32 (huggingface.co/openai/
# clip-vit-base-patch32/config.json): ViT-B/32 vision tower (224 px,
# patch 32: 49 patches + the class token), 12-layer causal text tower
CLIP_VIT_B32 = {
    "vision": {"hidden_size": 768, "num_hidden_layers": 12,
               "num_attention_heads": 12, "intermediate_size": 3072,
               "image_size": 224, "patch_size": 32, "layer_norm_eps": 1e-5},
    "text": {"hidden_size": 512, "num_hidden_layers": 12,
             "num_attention_heads": 8, "intermediate_size": 2048,
             "vocab_size": 49408, "max_position_embeddings": 77,
             "layer_norm_eps": 1e-5},
    "projection_dim": 512, "logit_scale_init_value": 2.6592,
    "initializer_range": 0.02,
}


def _cfg(config: dict) -> dict:
    cfg = dict(CLIP_VIT_B32, **config)
    cfg["vision"] = dict(CLIP_VIT_B32["vision"], **config.get("vision", {}))
    cfg["text"] = dict(CLIP_VIT_B32["text"], **config.get("text", {}))
    return cfg


class _Emitter:
    """Node-emission helpers over a GraphBuilder and a state dict."""

    def __init__(self, g: GraphBuilder, weights: dict):
        self.g = g
        self.w = weights

    def linear(self, x: str, key: str, name: str) -> str:
        """torch Linear: MatMul against the transposed weight, + the bias
        where the layer has one."""
        g = self.g
        w = g.init(f"{name}.weight_t",
                   np.ascontiguousarray(_f32(self.w[f"{key}.weight"]).T))
        y = g.node("MatMul", [x, w], out=f"{name}/MatMul_out")
        if f"{key}.bias" not in self.w:
            return y
        b = g.init(f"{name}.bias", _f32(self.w[f"{key}.bias"]))
        return g.node("Add", [y, b], out=f"{name}/Add_out")

    def layer_norm(self, x: str, key: str, eps: float, name: str) -> str:
        g = self.g
        w = g.init(f"{name}.weight", _f32(self.w[f"{key}.weight"]))
        b = g.init(f"{name}.bias", _f32(self.w[f"{key}.bias"]))
        return g.node("LayerNormalization", [x, w, b],
                      out=f"{name}/LN_out", epsilon=float(eps))

    def quickgelu(self, x: str, name: str) -> str:
        """QuickGELU: x * sigmoid(1.702 * x)."""
        g = self.g
        c = g.const(np.array(np.float32(1.702), dtype=np.float32), "qgelu_c")
        s = g.node("Mul", [x, c], out=f"{name}/scaled")
        sig = g.node("Sigmoid", [s], out=f"{name}/sigmoid")
        return g.node("Mul", [x, sig], out=f"{name}/qgelu")

    def attention(self, x: str, key: str, heads: int, hidden: int,
                  seq_len: int, name: str, mask: str | None = None) -> str:
        """CLIPAttention, HF eager order: separate biased q/k/v
        projections, head split, scores * scale (+ the additive causal
        mask on the text tower), softmax, context, out_proj."""
        g = self.g
        head_dim = hidden // heads
        q = self.linear(x, f"{key}.q_proj", f"{name}.q_proj")
        k = self.linear(x, f"{key}.k_proj", f"{name}.k_proj")
        v = self.linear(x, f"{key}.v_proj", f"{name}.v_proj")

        def split_heads(t: str, which: str) -> str:
            shape = g.const(np.array([0, seq_len, heads, head_dim],
                                     dtype=np.int64), "headshape")
            r = g.node("Reshape", [t, shape], out=f"{name}/{which}_Reshape")
            return g.node("Transpose", [r], out=f"{name}/{which}_Transpose",
                          perm=[0, 2, 1, 3])

        qh, kh, vh = (split_heads(t, w) for t, w in
                      ((q, "q"), (k, "k"), (v, "v")))
        kt = g.node("Transpose", [kh], out=f"{name}/k_T", perm=[0, 1, 3, 2])
        scores = g.node("MatMul", [qh, kt], out=f"{name}/scores")
        scal = g.const(np.array(np.float32(head_dim ** -0.5),
                                dtype=np.float32), "scale")
        scaled = g.node("Mul", [scores, scal], out=f"{name}/scaled")
        if mask is not None:
            scaled = g.node("Add", [scaled, mask], out=f"{name}/masked")
        probs = g.node("Softmax", [scaled], out=f"{name}/probs", axis=-1)
        ctx = g.node("MatMul", [probs, vh], out=f"{name}/context")
        ctx = g.node("Transpose", [ctx], out=f"{name}/context_T",
                     perm=[0, 2, 1, 3])
        merge = g.const(np.array([0, seq_len, hidden], dtype=np.int64),
                        "mergeshape")
        merged = g.node("Reshape", [ctx, merge], out=f"{name}/merged")
        return self.linear(merged, f"{key}.out_proj", f"{name}.out_proj")

    def encoder_layer(self, x: str, key: str, tower: dict, seq_len: int,
                      name: str, mask: str | None = None) -> str:
        """CLIPEncoderLayer (pre-LN): x + attn(ln1(x)), then
        x + mlp(ln2(x)) with QuickGELU."""
        g = self.g
        eps = tower["layer_norm_eps"]
        ln1 = self.layer_norm(x, f"{key}.layer_norm1", eps,
                              f"{name}.layer_norm1")
        att = self.attention(ln1, f"{key}.self_attn",
                             int(tower["num_attention_heads"]),
                             int(tower["hidden_size"]), seq_len,
                             f"{name}.self_attn", mask=mask)
        x1 = g.node("Add", [att, x], out=f"{name}/residual1")
        ln2 = self.layer_norm(x1, f"{key}.layer_norm2", eps,
                              f"{name}.layer_norm2")
        h = self.linear(ln2, f"{key}.mlp.fc1", f"{name}.mlp.fc1")
        h = self.quickgelu(h, f"{name}.mlp")
        h = self.linear(h, f"{key}.mlp.fc2", f"{name}.mlp.fc2")
        return g.node("Add", [h, x1], out=f"{name}/residual2")


def clip_dual_encoder(weights: dict, config: dict, batch_images: int = 2,
                      batch_texts: int = 3, seq_len: int = 8) -> O.ModelProto:
    """CLIPModel over ``pixel_values`` [B_img, 3, S, S] and text
    ``text_embeds_in`` [B_txt, T, H_txt] (token + position embeddings,
    gathered by the caller from ``_wte``/``_wpe``, which ride on the
    proto; EOS at position T-1, where the graph pools). Outputs, in order:
    ``logits_per_image`` [B_img, B_txt], ``image_embeds`` and
    ``text_embeds`` (L2-normalized). ``config``: ``CLIP_VIT_B32``'s
    layout."""
    cfg = _cfg(config)
    vcfg, tcfg = cfg["vision"], cfg["text"]
    vhid, thid = int(vcfg["hidden_size"]), int(tcfg["hidden_size"])
    size, patch = int(vcfg["image_size"]), int(vcfg["patch_size"])
    n_patch = (size // patch) ** 2
    w = weights
    g = GraphBuilder("clip_dual_encoder")
    e = _Emitter(g, w)

    # ---- vision tower -------------------------------------------------
    px = g.input("pixel_values", [batch_images, 3, size, size])
    vemb = "vision_model.embeddings"
    pw = g.init("vision.patch_embed.weight",
                _f32(w[f"{vemb}.patch_embedding.weight"]))
    patches = g.node("Conv", [px, pw], out="vision/patch_conv",
                     strides=[patch, patch], kernel_shape=[patch, patch])
    flat = g.const(np.array([0, vhid, n_patch], dtype=np.int64), "vflat")
    pr = g.node("Reshape", [patches, flat], out="vision/patch_flat")
    pt = g.node("Transpose", [pr], out="vision/patch_tokens", perm=[0, 2, 1])
    cls = g.init("vision.class_embedding", np.broadcast_to(
        _f32(w[f"{vemb}.class_embedding"]), (batch_images, 1, vhid)).copy())
    tokens = g.node("Concat", [cls, pt], out="vision/tokens", axis=1)
    vpos = g.init("vision.pos_embed",
                  _f32(w[f"{vemb}.position_embedding.weight"])[None])
    h = g.node("Add", [tokens, vpos], out="vision/embedded")
    h = e.layer_norm(h, "vision_model.pre_layrnorm", vcfg["layer_norm_eps"],
                     "vision.pre_ln")
    for i in range(int(vcfg["num_hidden_layers"])):
        h = e.encoder_layer(h, f"vision_model.encoder.layers.{i}", vcfg,
                            n_patch + 1, f"vision.layers.{i}")
    # pooled = post_layernorm(CLS)
    z = g.const(np.array([0], dtype=np.int64), "zero")
    one = g.const(np.array([1], dtype=np.int64), "one")
    ax1 = g.const(np.array([1], dtype=np.int64), "axis1")
    cls_tok = g.node("Slice", [h, z, one, ax1], out="vision/cls_slice")
    vshape = g.const(np.array([0, vhid], dtype=np.int64), "vpool_shape")
    pooled_v = g.node("Reshape", [cls_tok, vshape], out="vision/pooled")
    pooled_v = e.layer_norm(pooled_v, "vision_model.post_layernorm",
                            vcfg["layer_norm_eps"], "vision.post_ln")
    img_proj = e.linear(pooled_v, "visual_projection", "visual_projection")
    img_emb = g.node("LpNormalization", [img_proj],
                     out="image_embeds_n/normed", axis=-1, p=2)

    # ---- text tower (causal) -----------------------------------------
    tx = g.input("text_embeds_in", [batch_texts, seq_len, thid])
    # HF builds the causal mask with float32 min
    mval = np.finfo(np.float32).min
    cm = np.triu(np.full((seq_len, seq_len), mval, np.float32), k=1)
    cmask = g.init("text.causal_mask", cm[None, None])
    t = tx
    for i in range(int(tcfg["num_hidden_layers"])):
        t = e.encoder_layer(t, f"text_model.encoder.layers.{i}", tcfg,
                            seq_len, f"text.layers.{i}", mask=cmask)
    t = e.layer_norm(t, "text_model.final_layer_norm",
                     tcfg["layer_norm_eps"], "text.final_ln")
    # pool position T-1 (EOS by contract)
    last = g.const(np.array([seq_len - 1], dtype=np.int64), "tlast")
    tend = g.const(np.array([seq_len], dtype=np.int64), "tend")
    eos_tok = g.node("Slice", [t, last, tend, ax1], out="text/eos_slice")
    tshape = g.const(np.array([0, thid], dtype=np.int64), "tpool_shape")
    pooled_t = g.node("Reshape", [eos_tok, tshape], out="text/pooled")
    txt_proj = e.linear(pooled_t, "text_projection", "text_projection")
    txt_emb = g.node("LpNormalization", [txt_proj],
                     out="text_embeds_n/normed", axis=-1, p=2)

    # ---- similarity ----------------------------------------------------
    # logits_per_image = exp(logit_scale) * img @ text^T
    ls = g.const(np.array(np.exp(np.float32(w["logit_scale"])),
                          dtype=np.float32), "logit_scale")
    txt_t = g.node("Transpose", [txt_emb], out="text/emb_T", perm=[1, 0])
    sim = g.node("MatMul", [img_emb, txt_t], out="sim")
    g.node("Mul", [sim, ls], out="logits_per_image", name="logit_mul")

    proj = int(cfg["projection_dim"])
    g.output("logits_per_image", [batch_images, batch_texts])
    g.node("Identity", [img_emb], out="image_embeds", name="img_id")
    g.node("Identity", [txt_emb], out="text_embeds", name="txt_id")
    g.output("image_embeds", [batch_images, proj])
    g.output("text_embeds", [batch_texts, proj])

    model = g.model()
    model._wte = _f32(w["text_model.embeddings.token_embedding.weight"])
    model._wpe = _f32(w["text_model.embeddings.position_embedding.weight"])
    return model


def random_clip_weights(config: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """A CLIPModel state dict drawn like HF's init at factor 1: normal(0,
    ``initializer_range``) embeddings, normal q/k/v/out and MLP weights at
    HF's per-layer std, zero biases, LayerNorms 1/0, projections normal
    at hidden^-0.5, ``logit_scale`` at its init value."""
    cfg = _cfg(config)
    rng = np.random.default_rng(seed)
    std0 = float(cfg["initializer_range"])

    def normal(std, *shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    w = {"logit_scale": np.array(cfg["logit_scale_init_value"], np.float32)}

    def layer_norm(key, n):
        w[f"{key}.weight"] = np.ones(n, np.float32)
        w[f"{key}.bias"] = np.zeros(n, np.float32)

    for tower, prefix in (("vision", "vision_model"), ("text", "text_model")):
        t = cfg[tower]
        hid, inter = int(t["hidden_size"]), int(t["intermediate_size"])
        n_layer = int(t["num_hidden_layers"])
        in_std = hid ** -0.5 * (2 * n_layer) ** -0.5
        out_std = hid ** -0.5
        fc_std = (2 * hid) ** -0.5
        for i in range(n_layer):
            key = f"{prefix}.encoder.layers.{i}"
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                w[f"{key}.self_attn.{proj}.weight"] = normal(
                    out_std if proj == "out_proj" else in_std, hid, hid)
                w[f"{key}.self_attn.{proj}.bias"] = np.zeros(hid, np.float32)
            w[f"{key}.mlp.fc1.weight"] = normal(fc_std, inter, hid)
            w[f"{key}.mlp.fc1.bias"] = np.zeros(inter, np.float32)
            w[f"{key}.mlp.fc2.weight"] = normal(in_std, hid, inter)
            w[f"{key}.mlp.fc2.bias"] = np.zeros(hid, np.float32)
            layer_norm(f"{key}.layer_norm1", hid)
            layer_norm(f"{key}.layer_norm2", hid)
    v, t = cfg["vision"], cfg["text"]
    vhid, thid = int(v["hidden_size"]), int(t["hidden_size"])
    patch = int(v["patch_size"])
    n_pos = (int(v["image_size"]) // patch) ** 2 + 1
    emb = "vision_model.embeddings"
    w[f"{emb}.class_embedding"] = normal(vhid ** -0.5, vhid)
    w[f"{emb}.patch_embedding.weight"] = normal(std0, vhid, 3, patch, patch)
    w[f"{emb}.position_embedding.weight"] = normal(std0, n_pos, vhid)
    layer_norm("vision_model.pre_layrnorm", vhid)
    layer_norm("vision_model.post_layernorm", vhid)
    w["text_model.embeddings.token_embedding.weight"] = normal(
        std0, int(t["vocab_size"]), thid)
    w["text_model.embeddings.position_embedding.weight"] = normal(
        std0, int(t["max_position_embeddings"]), thid)
    layer_norm("text_model.final_layer_norm", thid)
    proj = int(cfg["projection_dim"])
    w["visual_projection.weight"] = normal(vhid ** -0.5, proj, vhid)
    w["text_projection.weight"] = normal(thid ** -0.5, proj, thid)
    return w
