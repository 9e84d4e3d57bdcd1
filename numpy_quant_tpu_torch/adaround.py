"""AdaRound: adaptive weight rounding (Nagel et al., arXiv:2004.10568);
port of ``numpy_quant_tpu/adaround.py``.

The PTQ pass rounds every weight to its nearest level; AdaRound learns
each element's rounding direction (floor or ceil) by minimizing the
layer's output reconstruction error on calibration data. A per-element
variable ``V`` with the rectified sigmoid ``h(V) = clip(1.2 sigmoid(V) -
0.1, 0, 1)`` is added to ``floor(W / s)``; the loss is the layer's output
MSE plus an annealed regularizer ``mean(1 - |2h - 1|^beta)`` pushing h to
0 or 1 (beta 20 -> 2). h starts at the true fractional remainder (zero
reconstruction error). Each layer optimizes alone with Adam on the float
calibration activations: ``torch.optim.Adam`` with optax's defaults
(betas 0.9 / 0.999, eps 1e-8), gradients from ``torch.autograd``, on the
model's device in float32 (TF32 off, ``config``).
"""
from __future__ import annotations

import numpy as np
import torch

from .intops import qrange
from .passes.weights import target_rows, weight_targets
from .tensor import QTensor


def _rect_sigmoid(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(v) * 1.2 - 0.1, 0.0, 1.0)


def adaround_weight(W: torch.Tensor, X: torch.Tensor, s: torch.Tensor,
                    lo: float, hi: float, transb: bool, iters: int,
                    lr: float, reg: float) -> torch.Tensor:
    """Tuned integer levels (float32, W's stored layout) of one weight W
    for y = X @ W (or X @ W.T with ``transb``); ``s`` broadcasts along the
    stored layout's output axis."""
    ratio = W / s
    base = torch.floor(ratio)
    frac = torch.clamp(ratio - base, 1e-4, 1 - 1e-4)
    # h(V0) == frac: start at the zero-error soft weight
    v = (-torch.log(1.2 / (frac + 0.1) - 1.0)).requires_grad_(True)
    y_ref = X @ (W.T if transb else W)
    lam = float(np.float32(reg)) * torch.mean(y_ref * y_ref)
    opt = torch.optim.Adam([v], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        _optimize(v, opt, base, s, X, y_ref, lam, lo, hi, transb, iters)
    with torch.no_grad():
        h_bin = (_rect_sigmoid(v) > 0.5).to(torch.float32)
        return torch.clamp(base + h_bin, lo, hi)


def _optimize(v, opt, base, s, X, y_ref, lam, lo, hi, transb: bool,
              iters: int) -> None:
    for i in range(int(iters)):
        beta = float(np.float32(20.0 - (20.0 - 2.0) * i
                                / max(iters - 1, 1)))
        h = _rect_sigmoid(v)
        wq = s * torch.clamp(base + h, lo, hi)
        y = X @ (wq.T if transb else wq)
        recon = torch.mean((y - y_ref) ** 2)
        r = torch.mean(1.0 - torch.abs(2.0 * h - 1.0) ** beta)
        loss = recon + lam * r
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()


def adaround_qmodel(qmodel, float_model, inputs: list, iters: int = 400,
                    lr: float = 1e-2, reg: float = 0.01,
                    max_rows: int = 2048) -> int:
    """Tune the rounding of every 2-D symmetric MatMul/Gemm weight of
    ``qmodel`` against ``float_model``'s activations on the calibration
    ``inputs``. Mutates the payloads in place; returns the number of tuned
    weights. Call BEFORE pack_weights()."""
    targets = weight_targets(qmodel, float_model)
    acts = target_rows(float_model, inputs, targets, max_rows)
    tuned = 0
    for node, w, W in targets:
        qt = w.data
        X = acts.get(node.inputs[0].name)
        transb = node.op == "Gemm" and bool(node.attrs.get("transB"))
        if X is None or X.shape[-1] != W.shape[1 if transb else 0]:
            continue
        # per-channel scales broadcast along the stored layout's output
        # axis: MatMul rhs [K, N] -> axis 1; Gemm transB [N, K] -> axis 0
        s = np.asarray(qt.scale, np.float32)
        if s.ndim > 0:
            s = s.reshape((1, -1) if not transb else (-1, 1))
        lo, hi = qrange(qt.bit_width)
        q = adaround_weight(W, X.to(W.device),
                            torch.from_numpy(np.array(s)).to(W.device),
                            lo, hi, transb, iters, lr, reg)
        w.data = QTensor(q.to(qt.data.dtype).contiguous(), qt.bit_width,
                         qt.scale, None)
        tuned += 1
    if tuned:
        qmodel.invalidate_params()
    return tuned
