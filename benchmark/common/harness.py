"""One run of one cell: load, warm up, measure, check, print one line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is found by its name in BENCHMARK.json:

* ``benchmark/configs/<config>.json``: the configuration as it is run, and
  ``benchmark/configs/<config>.py``: how the program is built from it,
  the work its products do, and the comparison with its plain reference
  (``benchmark/reference/``);
* ``benchmark/traffic/<mix>.json``: the mix's parameters, which the one
  generator (traffic.py) reads; the pieces it names are files too: its
  ``kind``, the loop that drives the program (``benchmark/loops/``), its
  ``arrivals`` (``benchmark/arrivals/``) and each length distribution
  (``benchmark/lengths/``);
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, a
  ``read(run)`` that returns its number or None where it found nothing
  to read.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "numpy_quant_tpu")


def load_module(path: str, name: str):
    """The Python file ``path`` as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A cell of BENCHMARK.json with everything its names lead to."""
    name: str
    chips: int
    spec: dict            # the configuration file
    mix: dict             # the traffic file
    config: object        # the configuration's module
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    bench: str = BENCH    # the benchmark's directory the files came from
    loop: object = None   # the loop module the mix's ``kind`` names

    @classmethod
    def find(cls, workload: str, root: str = ROOT) -> "Cell":
        """The cell ``workload`` of ``root``/BENCHMARK.json, its files read
        under ``root``."""
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        here = os.path.join(root, "benchmark")
        cell = next((w for w in bench["workloads"] if w["name"] == workload),
                    None)
        if cell is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

        def mine(m):
            return workload in m.get("workloads", [workload])

        from . import traffic
        mix = load_json(os.path.join(here, "traffic",
                                     cell["traffic"] + ".json"))
        return cls(
            name=workload, chips=int(cell["chips"]),
            spec=load_json(os.path.join(root, conf["file"])),
            mix=mix,
            config=load_module(os.path.join(
                here, "configs", cell["config"] + ".py"),
                "bench_config_" + cell["config"]),
            end_to_end=[m for m in bench["end_to_end"] if mine(m)],
            per_layer=[m for m in bench["per_layer"] if mine(m)],
            bench=here, loop=traffic.piece("loops", mix["kind"], here))


@dataclass
class Record:
    """What one window measured. ``e2e`` holds the end-to-end numbers the
    mix's loop took; ``stretch`` what the untraced stretch of a traced run
    counted for the per-layer readers; ``sample`` the outputs kept for the
    check."""
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: dict = field(default_factory=dict)
    stretch: dict = field(default_factory=dict)
    sample: dict = field(default_factory=dict)
    trace: object = None


@dataclass
class Run:
    """What a per-layer reader reads: the cell, the record, the trace and
    the card's peaks."""
    cell: Cell
    record: Record
    peak: dict

    @property
    def trace(self):
        return self.record.trace


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unknown"


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole (numpy_quant_tpu_torch is not
    numpy_quant_tpu)."""
    return sorted({m for m in list(sys.modules if names is None else names)
                   if m.split(".")[0] in FORBIDDEN})


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    the first run of a checkout builds (the program's own kernels go to
    build/kernels/ already)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t0: float, profile_s: float = 2.0) -> tuple:
    """Build, warm up and measure ``cell``; then free the program and
    check its outputs. Returns (record, setup_s, memory_peak_bytes,
    checks), ``checks`` a list of (name, value, limit)."""
    import torch
    system = cell.config.build(cell.spec, cell.mix, seed, device)
    state = cell.loop.warm(system, cell, seed, seconds)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    record = cell.loop.window(system, cell, state, seconds,
                         min(profile_s, seconds / 3) if trace else 0.0)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    kept = cell.config.free(system)
    del system, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.config.check(cell.spec, cell.mix, kept, record, seed,
                               device)
    return record, setup_s, peak, checks


def main(argv: list, t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = Cell.find(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from . import peaks
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    record, setup_s, peak, checks = measure(
        cell, args.seed, args.seconds, bool(args.trace), device, t0)
    correct = all(v <= lim for _, v, lim in checks)
    if args.trace:
        run = Run(cell, record, peaks.peaks(kind))
        metrics = {}
        for m in cell.per_layer:
            reader = load_module(os.path.join(cell.bench, "metrics",
                                              m["name"] + ".py"),
                                 "bench_metric_" + m["name"])
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        numbers = dict(record.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": numbers[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak), "power_limit": power_limit()}
    out = {"correct": bool(correct), "attempted": int(record.attempted),
           "failed": int(record.failed), "metrics": metrics, "device": dev}
    if args.trace:
        tr = record.trace
        dev["busy_s"] = tr.busy_s() if tr is not None else 0.0
        dev["window_s"] = tr.wall_s if tr is not None else 0.0
        if tr is not None:
            from .trace import breakdown
            out["breakdown"] = breakdown(tr)
    out["checked"] = [{"name": n, "value": v, "limit": lim}
                      for n, v, lim in checks]
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules loaded in this process: {bad}",
              file=sys.stderr)
        return 4
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
