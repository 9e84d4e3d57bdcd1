#!/usr/bin/env python3
"""Run one cell of the benchmark of numpy_quant_tpu_torch once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The run builds the cell's configuration from the seed, warms up
the shapes its traffic uses (set-up), measures for ``--seconds``, checks
the outputs against the plain reference, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checked`` holds each compared number beside its limit.
Exits non-zero, printing no result, without the devices or when a JAX
module was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    from benchmark.common.harness import main
    sys.exit(main(sys.argv[1:], T0))
