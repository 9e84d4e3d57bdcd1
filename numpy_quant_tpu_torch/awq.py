"""AWQ-style activation-aware weight scaling (Lin et al., arXiv:2306.00978);
port of ``numpy_quant_tpu/awq.py``.

The same exact norm-to-weights reparameterization as SmoothQuant
(smoothquant.py), but the per-group factor ``s_j = amax_x(j)^alpha`` takes
the alpha of the grid {0, 1/n, ..., 1} that minimizes the group's
weight-only reconstruction error ``||(x / s) @ fakequant(W * s) - x @ W||^2``
on calibration activations, the fake-quant being quantize_weights' own
symmetric scale choice (``quantization.weight_only_scales``' formula).
alpha = 0 is in the grid, so no group gets worse. The search runs in
float32 on the model's device; the factors and the rewrite are the JAX
package's host arithmetic. Run on the FLOAT model before
``quantize_weights`` (or ``quantize``) with the same bit width and grouping.
"""
from __future__ import annotations

import numpy as np
import torch

from .intops import qrange
from .passes.weights import float_array
from .smoothquant import apply_channel_scale, ln_matmul_groups
from .utils.parity import record_values


def _fake_quant_kn(W: torch.Tensor, bit_width: int, per_channel: bool,
                   group_size, groupable: bool) -> torch.Tensor:
    """Symmetric fake-quant of a [K, N]-oriented float32 device weight with
    ``weight_only_scales``' choice (channel axis 1): grouped abs-max scales
    where ``groupable`` and K divides, else per channel or per tensor."""
    min_q, max_q = qrange(bit_width)
    span = float(np.float32(max_q - min_q))
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=W.device)
    if groupable and group_size and W.shape[0] % int(group_size) == 0:
        g = int(group_size)
        amax = W.reshape(W.shape[0] // g, g, W.shape[1]).abs().amax(dim=1)
        scale = (2.0 * torch.maximum(amax, tiny)) / span
        scale = scale.repeat_interleave(g, dim=0)
    elif per_channel:
        amax = torch.maximum(W.abs().amax(dim=0, keepdim=True), tiny)
        scale = (2.0 * amax) / span
    else:
        # host float64 then float32, as weight_only_scales' per-tensor form
        absmax = max(float(W.abs().max()), 1e-12)
        scale = torch.tensor(np.float32(2.0 * absmax / (max_q - min_q)),
                             device=W.device)
    q = torch.round(torch.clamp(W / scale, min_q, max_q))
    return q * scale


def _groupable(w_const, axis: int, group_size) -> bool:
    """quantize_weights' grouping rule: grouped scales apply only when
    every consumer is a MatMul reading the weight as its rhs."""
    return bool(group_size) and axis == 0 and all(
        nd.op == "MatMul" and len(nd.inputs) > 1
        and nd.inputs[1] is w_const for nd in w_const.outputs)


def awq_scale_weights(model, inputs: list, bit_width: int = 4,
                      group_size: int = None, per_channel: bool = True,
                      n_grid: int = 20, max_tokens: int = 512,
                      rng: np.random.Generator = None) -> dict:
    """Grid-search the scaling exponent per norm group and apply the
    winner in place. ``bit_width``/``group_size``/``per_channel`` must
    match the ``quantize_weights`` call that follows. ``max_tokens`` caps
    the activation rows per group (a uniform subsample drawn from ``rng``,
    default ``default_rng(0)``, so the JAX package's rows). Returns
    {norm node name: best alpha}; groups whose best alpha is 0 stay as
    they were."""
    groups = ln_matmul_groups(model)
    acts = record_values(model, inputs, [g[3].name for g in groups])
    if rng is None:
        rng = np.random.default_rng(0)
    chosen: dict[str, float] = {}
    changed = 0
    for node, gamma, beta, out, ws in groups:
        x = acts.pop(out.name, None)
        g = float_array(gamma)
        k = g.shape[-1]
        if x is None or g.ndim != 1 or x.shape[-1] != k:
            continue
        x = x.reshape(-1, k)
        if x.shape[0] > max_tokens:
            pick = rng.choice(x.shape[0], max_tokens, replace=False)
            x = x[torch.from_numpy(pick).to(x.device)]
        amax_x = x.abs().amax(dim=0).cpu().numpy().astype(np.float64)
        if not np.any(amax_x > 0):
            continue
        # [K, N] orientation for every consumer: the norm channel axis is
        # K, the quantization channel axis N
        Ws, grp = [], []
        for w, axis in ws:
            W = w.data.data.to(torch.float32)
            Ws.append(W if axis == 0 else W.T)
            grp.append(_groupable(w, axis, group_size))
        refs = [x @ W for W in Ws]

        best_alpha, best_err, best_s = 0.0, None, None
        for i in range(n_grid + 1):
            alpha = i / n_grid
            s = amax_x ** alpha
            s = np.where(amax_x > 0, s, 1.0)
            # balance magnitudes (the AWQ reference implementation)
            s = s / np.sqrt(max(s.max() * s.min(), 1e-12))
            s = np.clip(s, 1e-5, None).astype(np.float32)
            sd = torch.from_numpy(s).to(x.device)
            xs = x / sd
            err = 0.0
            for W, ref, g_ok in zip(Ws, refs, grp):
                Wq = _fake_quant_kn(W * sd[:, None], bit_width, per_channel,
                                    group_size, g_ok)
                err += float(((xs @ Wq - ref) ** 2).sum())
            if best_err is None or err < best_err:
                best_alpha, best_err, best_s = alpha, err, s
        chosen[node.name] = best_alpha
        if best_alpha > 0:
            apply_channel_scale(gamma, beta, ws, best_s)
            changed += 1
    if changed:
        model.invalidate_params()
    return chosen
