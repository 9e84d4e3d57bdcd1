"""Sensitivity-based mixed weight precision (AMP-style, as in AIMET's
mixed-precision workflow, arXiv:2201.08442 section V); port of
``numpy_quant_tpu/utils/sensitivity.py``.

The planner measures each weight's output sensitivity to a low width in
isolation, then gives the low width to the least sensitive weights until
a parameter-count budget is met. Feed the returned ``{weight name: bits}``
to ``Model.quantize(weight_bit_width=...)``; ``pack_weights`` then stores
each weight at its width.

The search builds one QModel per weight and runs each once: it walks
eagerly (``config.eager_forward``), so no QModel captures a CUDA graph or
keeps a memory pool.
"""
from __future__ import annotations

import numpy as np

from .. import config
from ..graph import Constant, only_rhs_of
from ..tensor import FTensor


def _matmul_weights(model) -> list:
    """Float 2-D constants consumed only as MatMul/Gemm weights (the rule
    Model.quantize applies ``weight_bit_width`` with)."""
    return [v for v in model.values
            if isinstance(v, Constant) and isinstance(v.data, FTensor)
            and v.data.data.ndim == 2 and only_rhs_of(v, ("MatMul", "Gemm"))]


def weight_sensitivity(model, inputs: list, bit_width: int = 8,
                       low_bits: int = 4, stats: dict = None,
                       **quantize_kw) -> dict:
    """{weight name: mean |output delta|} when quantizing ONLY that weight
    at ``low_bits`` (everything else at ``bit_width``), against the
    all-``bit_width`` QModel on the calibration inputs, averaged over
    every graph output."""
    if stats is None:
        stats = model.calibration_stats(inputs)
    with config.eager_forward():
        base = model.quantize(bit_width=bit_width, stats=stats,
                              **quantize_kw)
        refs = base(inputs, as_numpy=False)
        del base
        sens = {}
        for w in _matmul_weights(model):
            q = model.quantize(bit_width=bit_width, stats=stats,
                               weight_bit_width={w.name: low_bits},
                               **quantize_kw)
            outs = q(inputs, as_numpy=False)
            sens[w.name] = float(np.mean([
                float((o - r).abs().mean())
                for o, r in zip(outs, refs)]))
    return sens


def plan_mixed_precision(model, inputs: list, low_frac: float = 0.5,
                         bit_width: int = 8, low_bits: int = 4,
                         stats: dict = None, **quantize_kw) -> dict:
    """A ``{weight name: low_bits}`` plan covering the least sensitive
    weights until ``low_frac`` of the total matmul-weight parameter count
    runs at ``low_bits``. Pass it to ``Model.quantize(weight_bit_width=)``."""
    sens = weight_sensitivity(model, inputs, bit_width=bit_width,
                              low_bits=low_bits, stats=stats, **quantize_kw)
    sizes = {w.name: int(w.data.data.numel()) for w in _matmul_weights(model)}
    budget = low_frac * sum(sizes.values())
    plan: dict = {}
    covered = 0
    for name in sorted(sens, key=sens.get):
        if covered >= budget:
            break
        plan[name] = low_bits
        covered += sizes[name]
    return plan
