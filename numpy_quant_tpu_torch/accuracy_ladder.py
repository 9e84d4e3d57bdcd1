"""Accuracy ladder on the trained modular-sum fixture (port of
``extras/modsum_accuracy_ladder.py``): teacher-forced sum accuracy
(``models/modsum_fixture.modsum_accuracy``) of the committed 4-layer GPT
under each quantization configuration, one JSON line per row. Plain
low-bit weight rounding fails this task; the accuracy passes (AWQ, GPTQ,
AdaRound) must recover measurably.

    python -m numpy_quant_tpu_torch.accuracy_ladder [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from . import Model
from .models import modsum_fixture as MF

BATCH = 256
# weight-only rows: (bits, group size, per channel)
WEIGHT_ONLY = [(8, None, True), (4, None, True), (4, 32, True),
               (3, 32, True), (2, 32, True), (4, None, False),
               (3, None, False)]


def ladder(device=None, emit=print, only=None) -> dict:
    """{row name: sum accuracy} of the ladder on ``device`` (CUDA unless
    given), each row passed to ``emit`` as a JSON line as it is done;
    with ``only`` (row names), those rows alone."""
    rng = np.random.default_rng(5)
    seqs = MF.make_modsum_batch(rng, BATCH)
    proto = MF.trained_modsum_onnx(batch_size=BATCH)
    x = np.take(proto._wte, seqs, axis=0).astype(np.float32)
    calib_ids = MF.make_modsum_batch(np.random.default_rng(17), 64)
    calib = np.take(proto._wte, calib_ids, axis=0).astype(np.float32)
    rows: dict = {}

    def row(name, make):
        if only is not None and name not in only:
            return
        rows[name] = MF.modsum_accuracy(make()([x])[0], seqs)
        emit(json.dumps({"config": name, "sum_acc": round(rows[name], 4)}))

    def fresh(batch: int = BATCH):
        return Model.from_onnx(MF.trained_modsum_onnx(batch_size=batch),
                               device=device)

    def weight_only(bw, gs, pc, awq):
        m = fresh()
        if awq:
            m.awq_scale_weights([calib], bit_width=bw, group_size=gs)
        m.quantize_weights(bit_width=bw, group_size=gs, pack=False,
                           per_channel=pc)
        return m

    row("float", fresh)
    for bw, gs, pc in WEIGHT_ONLY:
        tag = f"w{bw}" + (f"-g{gs}" if gs
                          else ("-perchan" if pc else "-pertensor"))
        for awq in (False, True):
            row(f"{tag}-{'awq' if awq else 'plain'}",
                lambda: weight_only(bw, gs, pc, awq))

    stats = []

    def static(wbw, label):
        if not stats:
            stats.append(fresh(calib.shape[0]).calibration_stats([calib]))
        qm = fresh().quantize(stats=stats[0], bit_width=8,
                              weight_bit_width=wbw,
                              per_channel_weights=wbw is not None)
        if label == "gptq":
            qm.gptq(fresh(), [calib])
        elif label == "adaround":
            qm.adaround(fresh(), [calib])
        return qm

    row("int8-ptq", lambda: static(None, "plain"))
    for wbw in (4, 3, 2):
        for label in ("plain", "gptq", "adaround"):
            row(f"w{wbw}a8-perchan-{label}", lambda: static(wbw, label))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    ladder(args.device, emit=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
