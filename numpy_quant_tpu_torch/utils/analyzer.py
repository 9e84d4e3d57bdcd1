"""Quantization error analyzer (port of
``numpy_quant_tpu/utils/analyzer.py``): the float and quantized executors
run side by side on one batch, and each graph value's signal-to-
quantization-noise ratio (SQNR) and mean |error| are reported, worst
first. A low-SQNR activation points at calibration, a low-SQNR matmul
output at weight precision."""
from __future__ import annotations

import numpy as np

from .parity import record_all_values


def quantization_report(float_model, qmodel, inputs,
                        top: int = None) -> list:
    """[(value name, sqnr_db, mean_abs_err, producer op), ...] sorted
    worst-SQNR-first over every value both executors produce. ``top``
    truncates the list. SQNR = 10 log10(E[x^2] / E[(x - x_q)^2]);
    infinite-SQNR (bit-identical) values are omitted."""
    f_acts = record_all_values(float_model, inputs)
    q_acts = record_all_values(qmodel, inputs)
    producer = {}
    for n in qmodel.nodes:
        for o in n.outputs:
            producer[o.name] = n.op

    rows = []
    for name in sorted(set(f_acts) & set(q_acts)):
        f = np.asarray(f_acts[name], np.float64)
        q = np.asarray(q_acts[name], np.float64)
        if f.shape != q.shape or not np.issubdtype(f.dtype, np.floating):
            continue
        noise = float(np.mean((f - q) ** 2))
        if noise == 0.0:
            continue  # bit-identical (shape-domain or pass-through)
        power = float(np.mean(f ** 2))
        sqnr = 10.0 * np.log10(power / noise) if power > 0 else -np.inf
        rows.append((name, round(sqnr, 2),
                     float(np.mean(np.abs(f - q))),
                     producer.get(name, "input")))
    rows.sort(key=lambda r: r[1])
    return rows[:top] if top else rows


def print_quantization_report(float_model, qmodel, inputs,
                              top: int = 20) -> None:
    """ASCII table of the worst ``top`` values by SQNR."""
    rows = quantization_report(float_model, qmodel, inputs, top=top)
    width = max([len(r[0]) for r in rows], default=4)
    print(f"{'value':<{width}}  {'SQNR dB':>8}  {'mean|err|':>10}  op")
    for name, sqnr, err, op in rows:
        print(f"{name:<{width}}  {sqnr:>8.2f}  {err:>10.4g}  {op}")
