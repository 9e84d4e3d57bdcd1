#!/usr/bin/env python3
"""The check's two readings on the card, at a cell's own size and load:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 8

For each seed one short window of the cell's traffic runs as a benchmark
run does, then prints one JSON line: the sound reading (the program as
the configuration states it) and the control's (the next precision below
the configuration's: for the int8 ViT the program's own W4A8 path, run
through the same window; for GPT-2 the reference in TF32 put first at
each served position of the same prompts and tokens). The limit in the
configuration's ``check`` lies between the largest sound reading and the
smallest control reading. Not run by the benchmark's timed runs.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(cell, seed: int, seconds: float, device) -> dict:
    import numpy as np
    import torch
    from benchmark.common import harness
    out = {"seed": seed}
    record, setup_s, _, checks = harness.measure(
        cell, seed, seconds, False, device, time.perf_counter())
    out["sound"] = checks[0][1]
    out["setup_s"] = setup_s
    out["e2e"] = record.e2e
    if cell.spec["model_type"] == "vit":
        lower = copy.copy(cell)
        lower.spec = dict(cell.spec, quantize=cell.spec["control"]["quantize"])
        _, _, _, checks = harness.measure(lower, seed, seconds, False,
                                          device, time.perf_counter())
        out["control"] = checks[0][1]
        return out
    from benchmark.reference.gpt2_w4 import GPT2W4
    w = cell.config.weights(cell.spec, seed, device)
    q = cell.spec["quantize_weights"]
    ref = GPT2W4(w, cell.spec, device, bits=q["bit_width"],
                 group=q["group_size"])
    reqs = record.sample["requests"]
    out["control"] = cell.config.served_gaps(ref, reqs, control=True)
    # how varied the served tokens are, and the control at the prompts'
    # positions too (a diagnostic: the check reads served positions)
    served = [t[p.size:] for p, t in reqs]
    out["served_tokens"] = int(sum(s.size for s in served))
    out["distinct_served"] = [int(np.unique(s).size) for s in served]
    worst, flips, flips_served = 0.0, 0, 0
    for p, t in reqs:
        want = ref.logits(t[:-1])
        got = ref.logits(t[:-1], tf32_products=True).argmax(-1)
        gap = want.max(-1).values - want.gather(1, got[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        flips += int((gap > 0).sum())
        flips_served += int((gap[p.size - 1:] > 0).sum())
    out["control_all_positions"] = worst
    out["control_flips"] = flips
    out["control_flips_served"] = flips_served
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args()
    from benchmark.common import harness
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.Cell.find(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, device)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
