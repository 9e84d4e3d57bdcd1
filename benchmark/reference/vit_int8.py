"""Plain PyTorch reference of the int8 ViTForImageClassification the
program serves: post-training quantization as the program's quantize()
defines it, worked out again from the weights and calibration images.

* Calibration: one float32 forward over the calibration images records
  the min and max of every value the quantized forward quantizes.
* Activations entering a product (the patch conv, each Linear, both
  attention products, the classifier) are quantized asymmetrically to
  int8: scale = (max - min) / 255, zero point = rint(-128 - min / scale);
  q = rint(clip(x / scale + zp, -128, 127)).
* Every float constant is quantized symmetrically per tensor at 8 bits,
  scale = 2 * max / 255 (the positive max, not the absolute one), so the
  LayerNorm weights of 1 become 127 * 2 / 255; biases of a Linear (after
  its MatMul) and the position embeddings round to the 32-bit grid of the
  value they are added to; biases of the conv and the classifier to the
  grid of their accumulator.
* Integer products are exact (float64 on integer values). The attention
  probabilities are quantized with their calibrated params before the
  context product. The conv and the classifier outputs requantize to
  int8 with their calibrated params; the logits are that int8 grid.
* Float work (LayerNorm eps 1e-12, exact-erf GELU, softmax, residuals) is
  float32 with TF32 off.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

QMIN, QMAX = -128, 127


def _asym(mn, mx, bits: int = 8) -> tuple:
    qmin, qmax = -2 ** (bits - 1), 2 ** (bits - 1) - 1
    mn, mx = np.float32(mn), np.float32(mx)
    scale = np.float32((mx - mn) / np.float32(qmax - qmin))
    zp = int(np.rint(np.float32(qmin - mn / scale))) if scale != 0 else 0
    return scale, zp


def _sym_scale(w: torch.Tensor, bits: int) -> np.float32:
    qmin, qmax = -2 ** (bits - 1), 2 ** (bits - 1) - 1
    mx = max(np.float32(w.max().item()), np.float32(w.min().item()))
    return np.float32(np.float32(2.0) * mx / np.float32(qmax - qmin))


def _t(v, dev) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=dev)


def quant(x: torch.Tensor, scale, zp, bits: int = 8) -> torch.Tensor:
    """Integer values (as float64) of x on the (scale, zp) grid."""
    qmin, qmax = -2 ** (bits - 1), 2 ** (bits - 1) - 1
    q = x.to(torch.float32) / _t(scale, x.device)
    if zp:
        q = q + _t(zp, x.device)
    return torch.round(torch.clamp(q, qmin, qmax)).to(torch.float64)


def sym_const(w: torch.Tensor, bits: int) -> tuple:
    """(integer values, scale) of a constant quantized symmetrically."""
    scale = _sym_scale(w, bits)
    if scale == 0:
        return torch.zeros_like(w, dtype=torch.float64), scale
    return quant(w, scale, 0, bits), scale


def bias_grid(b: torch.Tensor, scale) -> torch.Tensor:
    """A bias on the 32-bit grid of ``scale``, back in float32."""
    s = _t(scale, b.device)
    q = torch.round(torch.clamp(b / s, -2.0 ** 31, 2.0 ** 31 - 1))
    return q * s


def requant(acc_f32: torch.Tensor, scale, zp) -> torch.Tensor:
    """Float accumulator values onto an int8 grid: times 1/scale, +zp,
    rint, clip; returned dequantized (float32)."""
    inv = np.float32(np.float32(1.0) / np.float32(scale))
    q = acc_f32 * _t(inv, acc_f32.device) + _t(zp, acc_f32.device)
    q = torch.clamp(torch.round(q), QMIN, QMAX)
    return (q - zp) * _t(scale, acc_f32.device)


class ViTInt8:
    """The reference classifier over ``weights`` (HF
    ViTForImageClassification keys, numpy float32) and ``cfg`` (HF
    ViTConfig keys). ``bits``: the weights' width (8; the activations are
    always 8 bits)."""

    def __init__(self, weights: dict, cfg: dict, device, bits: int = 8):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.w = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                  for k, v in weights.items()}
        self.cfg = cfg
        self.dev = device
        self.bits = bits
        self.p = None

    # ------------------------------------------------------------ float

    def _ln(self, x, key, quantized):
        g, b = self.w[key + ".weight"], self.w[key + ".bias"]
        if quantized:
            gq, gs = sym_const(g, 8)
            bq, bs = sym_const(b, 8)
            g = (gq * float(gs)).to(torch.float32) if gs else g * 0
            b = (bq * float(bs)).to(torch.float32) if bs else b * 0
        return F.layer_norm(x, (x.shape[-1],), g, b,
                            float(self.cfg["layer_norm_eps"]))

    def calibrate(self, images: np.ndarray) -> None:
        """Records the min/max of each quantized value over ``images``."""
        rec = {}

        def see(name, t):
            mn, mx = float(t.min()), float(t.max())
            rec[name] = (mn, mx)
            return t

        w, cfg = self.w, self.cfg
        x = see("x", torch.from_numpy(images).to(self.dev))
        conv = see("conv", F.conv2d(
            x, w["vit.embeddings.patch_embeddings.projection.weight"],
            w["vit.embeddings.patch_embeddings.projection.bias"],
            stride=int(cfg["patch_size"])))
        h = self._embed(conv, w["vit.embeddings.cls_token"], see)
        for i in range(int(cfg["num_hidden_layers"])):
            h = self._layer_float(h, f"vit.encoder.layer.{i}", f"{i}.", see)
        h = self._ln(h, "vit.layernorm", False)
        cls = see("cls", h[:, 0])
        see("logits", cls @ w["classifier.weight"].T + w["classifier.bias"])
        self.p = {k: _asym(*v) for k, v in rec.items()}

    def _embed(self, conv, cls_token, see, pos_scale=None):
        b = conv.shape[0]
        patches = conv.flatten(2).transpose(1, 2)
        tokens = see("tokens", torch.cat(
            [cls_token.expand(b, -1, -1), patches], dim=1))
        pos = self.w["vit.embeddings.position_embeddings"]
        if pos_scale is not None:
            pos = bias_grid(pos, pos_scale)
        return tokens + pos

    def _layer_float(self, h, key, tag, see):
        w = self.w
        heads = int(self.cfg["num_attention_heads"])
        ln1 = see(tag + "ln1", self._ln(h, key + ".layernorm_before", False))

        def lin(x, k, name):
            y = see(tag + name + "_mm", x @ w[k + ".weight"].T)
            return see(tag + name, y + w[k + ".bias"])

        att = key + ".attention.attention"
        q = lin(ln1, att + ".query", "q")
        k = lin(ln1, att + ".key", "k")
        v = lin(ln1, att + ".value", "v")
        b, n, d = q.shape
        hd = d // heads
        split = lambda t: t.reshape(b, n, heads, hd).transpose(1, 2)
        s = (split(q) @ split(k).transpose(-1, -2)) * np.float32(
            1.0 / np.sqrt(hd))
        probs = see(tag + "probs", torch.softmax(s, dim=-1))
        ctx = see(tag + "ctx", (probs @ split(v)).transpose(1, 2)
                  .reshape(b, n, d))
        x1 = lin(ctx, key + ".attention.output.dense", "o") + h
        ln2 = see(tag + "ln2", self._ln(x1, key + ".layernorm_after", False))
        fc1 = lin(ln2, key + ".intermediate.dense", "fc1")
        g = see(tag + "gelu", F.gelu(fc1))
        return lin(g, key + ".output.dense", "fc2") + x1

    # -------------------------------------------------------- quantized

    def _qlinear(self, x, key, xname, outname):
        """Quantized x @ W^T + b: x on its calibrated grid, W symmetric,
        the exact product back in float32, the bias on the grid of the
        product's calibrated range."""
        sx, zx = self.p[xname]
        wq, sw = sym_const(self.w[key + ".weight"], self.bits)
        acc = (quant(x, sx, zx) - zx) @ wq.T
        y = acc.to(torch.float32) * _t(np.float32(sx * sw), x.device)
        return y + bias_grid(self.w[key + ".bias"], self.p[outname + "_mm"][0])

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """float32 logits [B, num_labels] of ``images`` [B, 3, H, W]."""
        if self.p is None:
            raise RuntimeError("calibrate() first")
        w, p, cfg = self.w, self.p, self.cfg
        heads = int(cfg["num_attention_heads"])
        x = images.to(self.dev, torch.float32)
        # patch conv: int8 x, int8 W, bias on the accumulator grid,
        # requantized to int8
        sx, zx = p["x"]
        cw, csw = sym_const(
            w["vit.embeddings.patch_embeddings.projection.weight"], 8)
        acc = F.conv2d(quant(x, sx, zx) - zx, cw,
                       stride=int(cfg["patch_size"]))
        s_acc = np.float32(sx * csw)
        acc = acc + torch.round(torch.clamp(
            w["vit.embeddings.patch_embeddings.projection.bias"].double()
            / float(s_acc), -2.0 ** 31, 2.0 ** 31 - 1))[None, :, None, None]
        conv = requant(acc.to(torch.float32) * _t(s_acc, x.device),
                       *p["conv"])
        cq, cs = sym_const(w["vit.embeddings.cls_token"], 8)
        h = self._embed(conv, (cq * float(cs)).to(torch.float32),
                        lambda n, t: t, pos_scale=p["tokens"][0])
        for i in range(int(cfg["num_hidden_layers"])):
            key, tag = f"vit.encoder.layer.{i}", f"{i}."
            ln1 = self._ln(h, key + ".layernorm_before", True)
            att = key + ".attention.attention"
            q = self._qlinear(ln1, att + ".query", tag + "ln1", tag + "q")
            k = self._qlinear(ln1, att + ".key", tag + "ln1", tag + "k")
            v = self._qlinear(ln1, att + ".value", tag + "ln1", tag + "v")
            b, n, d = q.shape
            hd = d // heads
            split = lambda t: t.reshape(b, n, heads, hd).transpose(1, 2)
            (sq, zq), (sk, zk), (sv, zv) = (p[tag + "q"], p[tag + "k"],
                                            p[tag + "v"])
            qi = split(quant(q, sq, zq) - zq)
            ki = split(quant(k, sk, zk) - zk)
            vi = split(quant(v, sv, zv) - zv)
            s = (qi @ ki.transpose(-1, -2)).to(torch.float32) \
                * _t(np.float32(sq * sk), x.device) \
                * _t(np.float32(1.0 / np.sqrt(hd)), x.device)
            probs = torch.softmax(s, dim=-1)
            sp, zp = p[tag + "probs"]
            pq = quant(probs, sp, zp) - zp
            ctx = (pq @ vi).to(torch.float32) \
                * _t(np.float32(sp * sv), x.device)
            ctx = ctx.transpose(1, 2).reshape(b, n, d)
            x1 = self._qlinear(ctx, key + ".attention.output.dense",
                               tag + "ctx", tag + "o") + h
            ln2 = self._ln(x1, key + ".layernorm_after", True)
            fc1 = self._qlinear(ln2, key + ".intermediate.dense",
                                tag + "ln2", tag + "fc1")
            h = self._qlinear(F.gelu(fc1), key + ".output.dense",
                              tag + "gelu", tag + "fc2") + x1
        cls = self._ln(h, "vit.layernorm", True)[:, 0]
        sx, zx = p["cls"]
        wq, sw = sym_const(w["classifier.weight"], self.bits)
        s_acc = np.float32(sx * sw)
        acc = (quant(cls, sx, zx) - zx) @ wq.T
        acc = acc + torch.round(torch.clamp(
            w["classifier.bias"].double() / float(s_acc),
            -2.0 ** 31, 2.0 ** 31 - 1))
        return requant(acc.to(torch.float32) * _t(s_acc, x.device),
                       *p["logits"])
