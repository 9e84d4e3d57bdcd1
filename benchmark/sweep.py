#!/usr/bin/env python3
"""Find the highest arrival rate an open-loop cell sustains (its knee):

    python3 benchmark/sweep.py --workload gpt2_w4.chat \
        --rates 40,50,60,70 --seconds 10 --seeds 1,2,3

Builds the cell once (its weights from the first seed), then runs its
traffic at each rate in turn, once for each seed (each seed orders the
same arrival gaps and sizes another way; the engine reset between runs),
and prints one JSON line a run: the p50 and
p95 of time to first token and time per output token, the requests that
waited in the queue over the window's first and last thirds, and whether
the queue grew (the last third's mean above twice the first's plus one
slot's worth). The knee is the highest rate whose queue grew under no
seed. Requests still unfinished ``--drain`` seconds past the close count
as failed. Not
run by the benchmark's timed runs; the chosen rate is written into the
mix's file as a number.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--drain", type=float, default=10.0)
    args = ap.parse_args()
    import dataclasses
    from benchmark.common import harness
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.Cell.find(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    system = cell.config.build(cell.spec, cell.mix, seeds[0], device)
    for rate, seed in ((float(r), s) for r in args.rates.split(",")
                       for s in seeds):
        at = dataclasses.replace(cell, mix=dict(cell.mix, rate=rate,
                                                drain_s=args.drain))
        state = cell.loop.warm(system, at, seed, args.seconds)
        rec = cell.loop.window(system, at, state, args.seconds, 0.0)
        q = [n for t, n in rec.stretch["queue"] if t < args.seconds]
        third = max(1, len(q) // 3)
        first = sum(q[:third]) / third
        last = sum(q[-third:]) / third
        print(json.dumps({
            "rate": rate, "seed": seed, "requests": rec.attempted,
            "failed": rec.failed,
            "ttft_p95_ms": rec.e2e["ttft_p95_ms"],
            "tpot_p95_ms": rec.e2e["tpot_p95_ms"],
            "late_s": rec.e2e["requests_late_s"],
            "step_ms": rec.stretch["step_ms"],
            "queue_first_third": first, "queue_last_third": last,
            "grows": last > 2 * first + 1,
            "ttft_p50_ms": rec.e2e["ttft_p50_ms"]}),
            flush=True)
        system.engine.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
