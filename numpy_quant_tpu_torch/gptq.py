"""GPTQ: Hessian-guided sequential weight quantization (Frantar et al.,
arXiv:2210.17323); port of ``numpy_quant_tpu/gptq.py``.

Rounding each weight to its nearest level ignores how the layer's output
moves. GPTQ quantizes the contraction (K) axis row by row and, after
fixing each row, updates the rows not yet quantized to absorb its error,
weighted by the inverse Hessian of the layer reconstruction loss
(H = 2 X^T X on the calibration activations). Same grid as the PTQ pass
(symmetric per-tensor or per-channel scales), other integers. Compose
``quantize -> gptq | adaround -> correct_biases -> optimize ->
pack_weights``.

The Hessian, its inverse, the Cholesky factor and the row-sequential
update run in float64 torch on the model's device, row by row in the JAX
package's order (no lazy-batch reordering). ``torch.linalg`` and numpy's
LAPACK differ in the last ulps of the inverse, so a level may differ from
the JAX package's where ``rint`` meets a near-tie.
"""
from __future__ import annotations

import numpy as np
import torch

from .intops import qrange
from .passes.weights import target_rows, weight_targets
from .tensor import QTensor


def gptq_rows(W: torch.Tensor, X: torch.Tensor, scale: np.ndarray,
              lo: float, hi: float, percdamp: float) -> torch.Tensor:
    """Integer levels [K, N] (float64, in [lo, hi]) of W [K, N] for
    y = X @ W, X [M, K], on W's device. ``scale``: host float32, a scalar
    or one per output channel."""
    k, n = W.shape
    dev = W.device
    H = 2.0 * (X.T @ X).to(torch.float64)
    # dampen: keeps the Cholesky well-posed for rank-deficient X
    damp = percdamp * float(torch.diagonal(H).mean())
    idx = torch.arange(k, device=dev)
    H[idx, idx] += max(damp, 1e-8)
    # upper Cholesky factor of H^-1 (Hinv = U^T U): its rows drive the
    # sequential conditioning
    Hinv = torch.linalg.inv(H)
    U = torch.linalg.cholesky(Hinv).T.contiguous()
    Wf = W.to(torch.float64).clone()
    Q = torch.zeros_like(Wf)
    s = torch.from_numpy(np.broadcast_to(
        np.asarray(scale, np.float64), (1, n)).reshape(n).copy()).to(dev)
    for i in range(k):
        d = U[i, i]
        q = torch.clamp(torch.round(Wf[i] / s), lo, hi)
        Q[i] = q
        err = (Wf[i] - q * s) / d
        if i + 1 < k:
            Wf[i + 1:] -= torch.outer(U[i, i + 1:], err)
    return Q


def gptq_qmodel(qmodel, float_model, inputs: list, percdamp: float = 0.01,
                max_rows: int = 4096) -> int:
    """Requantize every 2-D symmetric MatMul/Gemm weight of ``qmodel``
    with GPTQ against ``float_model``'s activations on the calibration
    ``inputs``: same (scale, bit width) grid, Hessian-guided integers.
    Mutates the payloads in place; call BEFORE pack_weights(). Returns
    the number of requantized weights."""
    targets = weight_targets(qmodel, float_model)
    acts = target_rows(float_model, inputs, targets, max_rows)
    tuned = 0
    for node, w, W in targets:
        qt = w.data
        X = acts.get(node.inputs[0].name)
        transb = node.op == "Gemm" and bool(node.attrs.get("transB"))
        if X is None or X.shape[-1] != W.shape[1 if transb else 0]:
            continue
        lo, hi = qrange(qt.bit_width)
        s = np.asarray(qt.scale, np.float32).reshape(-1)
        X = X.to(W.device)
        if transb:
            # stored [N, K]: solve in the [K, N] orientation
            Q = gptq_rows(W.T, X, s, lo, hi, percdamp).T
        else:
            Q = gptq_rows(W, X, s, lo, hi, percdamp)
        w.data = QTensor(Q.to(qt.data.dtype).contiguous(), qt.bit_width,
                         qt.scale, None)
        tuned += 1
    if tuned:
        qmodel.invalidate_params()
    return tuned
