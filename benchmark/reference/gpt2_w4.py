"""Plain PyTorch reference of GPT-2 with weight-only quantized products,
as the program serves it: every Linear weight and the tied head
(wte^T) symmetric at ``bits`` with one scale per ``group`` input rows and
output column, scale = 2 * absmax / (2^bits - 1), q = rint(clip(w / scale,
-2^(bits-1), 2^(bits-1) - 1)); the embeddings, biases and LayerNorms stay
float32. Everything else is the published GPT2LMHeadModel over a whole
sequence, in float32 with TF32 off, the GELU exact (erf), LayerNorm eps
from the config, causal attention scaled by 1/sqrt(head dim).

``tf32=True`` rounds every product's operands to TF32 (10 mantissa bits,
to nearest even) and accumulates in float32: the next precision below
the configuration's, the check's control."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def dequant_grouped(w: np.ndarray, bits: int, group: int) -> np.ndarray:
    """w [K, N] float32 on its grouped symmetric grid (host float32, IEEE
    division), back in float32; per output column where K % group != 0."""
    qmin, qmax = -2 ** (bits - 1), 2 ** (bits - 1) - 1
    k, n = w.shape
    if k % group == 0:
        grp = w.reshape(k // group, group, n)
        absmax = np.maximum(np.abs(grp).max(axis=1), np.float32(1e-12))
        scale = (np.float32(2.0) * absmax / np.float32(qmax - qmin)) \
            .astype(np.float32)
        full = np.repeat(scale, group, axis=0)
    else:
        absmax = np.maximum(np.abs(w).max(axis=0, keepdims=True),
                            np.float32(1e-12))
        full = (np.float32(2.0) * absmax / np.float32(qmax - qmin)) \
            .astype(np.float32)
    q = np.rint(np.clip(w / full, qmin, qmax))
    return (q * full).astype(np.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (the low 13 mantissa bits cleared, to
    nearest even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class GPT2W4:
    """The reference LM over ``weights`` (HF GPT2LMHeadModel keys, numpy
    float32) and ``cfg`` (HF GPT2Config keys)."""

    def __init__(self, weights: dict, cfg: dict, device, bits: int = 4,
                 group: int = 128):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.dev = device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.w = {}
        for key, v in weights.items():
            v = np.asarray(v, np.float32)
            if key.endswith(".weight") and v.ndim == 2 and (
                    ".attn." in key or ".mlp." in key):
                v = dequant_grouped(v, bits, group)
            self.w[key] = put(v)
        self.head = put(dequant_grouped(
            np.ascontiguousarray(np.asarray(weights["transformer.wte.weight"],
                                            np.float32).T), bits, group))

    def logits(self, ids: np.ndarray, tf32_products: bool = False,
               rows: slice = slice(None)) -> torch.Tensor:
        """float32 logits [len(ids[rows]), vocab] of one sequence ``ids``
        at the positions ``rows``."""
        w, cfg = self.w, self.cfg
        mm = (lambda a, b: tf32(a) @ tf32(b)) if tf32_products \
            else (lambda a, b: a @ b)
        t = torch.as_tensor(np.asarray(ids, np.int64), device=self.dev)
        n = t.numel()
        nh = int(cfg["n_head"])
        d = int(cfg["n_embd"])
        hd = d // nh
        eps = float(cfg["layer_norm_epsilon"])
        h = w["transformer.wte.weight"][t] + w["transformer.wpe.weight"][:n]
        mask = torch.full((n, n), float("-inf"), device=self.dev).triu(1)
        for i in range(int(cfg["n_layer"])):
            k = f"transformer.h.{i}"
            x = F.layer_norm(h, (d,), w[k + ".ln_1.weight"],
                             w[k + ".ln_1.bias"], eps)
            qkv = mm(x, w[k + ".attn.c_attn.weight"]) \
                + w[k + ".attn.c_attn.bias"]
            q, kk, v = (z.reshape(n, nh, hd).transpose(0, 1)
                        for z in qkv.split(d, dim=-1))
            s = mm(q, kk.transpose(-1, -2)) * np.float32(1.0 / np.sqrt(hd))
            a = mm(torch.softmax(s + mask, dim=-1), v)
            a = a.transpose(0, 1).reshape(n, d)
            h = h + mm(a, w[k + ".attn.c_proj.weight"]) \
                + w[k + ".attn.c_proj.bias"]
            x = F.layer_norm(h, (d,), w[k + ".ln_2.weight"],
                             w[k + ".ln_2.bias"], eps)
            f = F.gelu(mm(x, w[k + ".mlp.c_fc.weight"])
                       + w[k + ".mlp.c_fc.bias"])
            h = h + mm(f, w[k + ".mlp.c_proj.weight"]) \
                + w[k + ".mlp.c_proj.bias"]
        h = F.layer_norm(h[rows], (d,), w["transformer.ln_f.weight"],
                         w["transformer.ln_f.bias"], eps)
        return mm(h, self.head)
