"""One run of each cell through the command the benchmark is run by, at
the benchmark's own length (a shorter batch window finishes no request,
so its check has nothing to judge); needs a CUDA card (the ``card``
fixture skips without one)."""
import json
import os
import subprocess
import sys

import pytest

from benchmark.common import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_one_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", str(BENCH["run_seconds"]),
         "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checked"]
    assert line["device"]["platform"] == "gpu"
