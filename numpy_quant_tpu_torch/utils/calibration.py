"""Clipped calibration: MSE-optimal and KL (entropy) ranges; port of
``numpy_quant_tpu/utils/calibration.py``.

Min/max calibration spends levels on the rarest outlier. These searches
pick, per activation, the clip range that minimizes the quantization
error on the calibration data (MSE, the mainstream toolchains' "MSE"
calibrator) or the information lost by the quantized distribution (KL,
TensorRT's method). Both return a standard ``{value name: (min, max)}``
stats dict for ``Model.quantize(stats=...)``; constants (weights) and
integer values keep their exact min/max.

One eager walk reduces every value on the device to its min, max and a
strided sample of at most ``max_elems`` elements (the JAX package's
subsample). The MSE search evaluates every grid point of a side at once
on the device; the KL search builds the sample's 512-bin histogram and
scans its thresholds on the host in numpy, the JAX package's code.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph import Constant
from ..intops import qrange
from ..quantization import quant_parameters
from ..tensor import FTensor, ITensor, QTensor


def _summaries(model, inputs: list, max_elems: int, absolute: bool) -> dict:
    """{name: (min, max, sample or None)} of every value of one eager walk:
    integer values and constants without a sample; float activations
    with their flattened float32 elements (their magnitudes when
    ``absolute``), every (size // max_elems + 1)th kept above
    ``max_elems``, on the model's device."""
    const_names = {v.name for v in model.values if isinstance(v, Constant)}
    out = {}

    def visit(name, tensor):
        if isinstance(tensor, QTensor):
            tensor = tensor.dequantize()
        if isinstance(tensor, ITensor):
            d = tensor.data
            out[name] = (np.float32(d.min()), np.float32(d.max()), None)
            return
        if not isinstance(tensor, FTensor):
            return
        d = tensor.data.to(torch.float32).reshape(-1)
        ext = torch.stack([d.min(), d.max()])
        sample = None
        if name not in const_names:
            if absolute:
                d = d.abs()
            if d.numel() > max_elems:
                d = d[:: d.numel() // max_elems + 1]
            sample = d.clone()
        out[name] = (ext, None, sample)

    with torch.no_grad():
        input_tensors = {v.name: model._wrap_input(a, v)
                         for a, v in zip(inputs, model.inputs)}
        model._forward(input_tensors, visit=visit)
    device = [n for n, (ext, mx, _) in out.items() if mx is None]
    if device:
        extremes = torch.stack([out[n][0] for n in device]).cpu().numpy()
        for name, (mn, mx) in zip(device, extremes):
            out[name] = (np.float32(mn), np.float32(mx), out[name][2])
    return out


def _mse_for_ranges(x: torch.Tensor, ranges: list, bit_width: int):
    """Quantization MSE of ``x`` under each (min, max) of ``ranges``
    (asymmetric, the JAX package's formula in float32), host float list;
    inf where a range's scale is 0."""
    lo, hi = qrange(bit_width)
    params = [quant_parameters(np.float32(mn), np.float32(mx),
                               bit_width=bit_width, asymmetric=True)
              for mn, mx in ranges]
    scales = np.array([np.float32(s) for s, _ in params], np.float32)
    zps = np.array([0.0 if zp is None else float(zp) for _, zp in params],
                   np.float32)
    s = torch.from_numpy(np.where(scales == 0, 1, scales)).to(x.device)[:, None]
    z = torch.from_numpy(zps).to(x.device)[:, None]
    q = torch.round(torch.clamp(x[None, :] / s + z, lo, hi))
    mse = (((q - z) * s - x[None, :]) ** 2).mean(dim=1).cpu().numpy()
    return [np.inf if sc == 0 else float(m) for sc, m in zip(scales, mse)]


def mse_clipped_stats(model, inputs: list, bit_width: int = 8,
                      grid: int = 24, shrink: float = 0.02,
                      max_elems: int = 20000, sweeps: int = 2) -> dict:
    """Per-value MSE-optimal clip ranges on the calibration ``inputs``:
    each activation's min and max shrink by per-side factors, searched
    coordinate-wise over ``grid`` geometric points in [shrink, 1] in
    ``sweeps`` alternating rounds, minimizing its quantization MSE at
    ``bit_width`` on its sample."""
    factors = np.geomspace(max(shrink, 1e-4), 1.0, int(grid))
    stats: dict = {}
    for name, (mn, mx, x) in _summaries(model, inputs, max_elems,
                                        absolute=False).items():
        if x is None or mn == mx:
            stats[name] = (mn, mx)
            continue
        f_lo, f_hi = 1.0, 1.0
        best = _mse_for_ranges(x, [(mn, mx)], bit_width)[0]
        for _ in range(max(1, int(sweeps))):
            # each side's candidates at once; the first strict minimum
            # below the best so far wins, as the sequential scan picks it
            for side in ("lo", "hi"):
                ranges = [(mn * f, mx * f_hi) if side == "lo"
                          else (mn * f_lo, mx * f) for f in factors]
                mses = _mse_for_ranges(x, ranges, bit_width)
                i = int(np.argmin(mses))
                if mses[i] < best:
                    best = mses[i]
                    if side == "lo":
                        f_lo = float(factors[i])
                    else:
                        f_hi = float(factors[i])
        stats[name] = (np.float32(mn * f_lo), np.float32(mx * f_hi))
    return stats


def _kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    mask = p > 0
    qm = np.where(q > 0, q, 1e-12)
    return float(np.sum(p[mask] * np.log(p[mask] / qm[mask])))


def kl_calibrated_stats(model, inputs: list, bit_width: int = 8,
                        n_bins: int = 512, max_elems: int = 20000) -> dict:
    """Entropy (KL-divergence) calibration: per activation, a |x|
    histogram of its sample and the clip threshold whose quantized
    distribution (folded into 2^bit_width levels, clipped tail mass on
    the edge bin) loses the least information. Symmetric thresholds; the
    range is ``(-T, T)`` intersected with the observed min/max."""
    n_levels = int(2 ** bit_width)
    stats: dict = {}
    for name, (mn, mx, x) in _summaries(model, inputs, max_elems,
                                        absolute=True).items():
        if x is None or mn == mx:
            stats[name] = (mn, mx)
            continue
        x = x.cpu().numpy()
        amax = float(x.max())
        hist, edges = np.histogram(x, bins=n_bins, range=(0.0, amax))
        hist = hist.astype(np.float64)
        best_t, best_kl = amax, np.inf
        # candidate thresholds: every bin edge from n_levels bins up
        for i in range(max(n_levels, n_bins // 8), n_bins + 1):
            ref = hist[:i].copy()
            ref[i - 1] += hist[i:].sum()      # clipped tail -> edge
            if ref.sum() == 0:
                continue
            # fold i bins into n_levels levels, then expand back
            idx = (np.arange(i) * n_levels // i)
            q = np.zeros(n_levels)
            np.add.at(q, idx, ref)
            counts = np.bincount(idx, minlength=n_levels)
            expanded = np.where(counts[idx] > 0, q[idx] / counts[idx], 0)
            p = ref / ref.sum()
            e = expanded / max(expanded.sum(), 1e-12)
            kl = _kl_divergence(p, e)
            if kl < best_kl:
                best_kl, best_t = kl, float(edges[i])
        stats[name] = (np.float32(max(mn, -best_t)),
                       np.float32(min(mx, best_t)))
    return stats
