"""What every loop shares. A loop is the file ``benchmark/loops/<kind>.py``
that a traffic mix's ``kind`` names, with two functions:

* ``warm(system, cell, seed, seconds)`` makes the mix's inputs from the
  seed and runs every shape the window will run (set-up), returning the
  window's state;
* ``window(system, cell, state, seconds, profile_s)`` measures for
  ``seconds`` and returns a ``harness.Record``: with ``profile_s`` > 0 (a
  traced run) the last ``profile_s`` of the window run under the profiler
  and the rest is the untraced stretch the per-layer readers time. It
  keeps a seeded sample of its outputs for the check.

A new kind of traffic is a new file there; no file here changes."""
from __future__ import annotations

import os

import numpy as np

from .harness import ROOT

TRACE_PATH = os.path.join(ROOT, "build", "benchmark", "trace.json")


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()


def pick(rng: np.random.Generator, n: int, k: int) -> list:
    """``k`` of ``range(n)`` (all where ``n`` <= ``k``), drawn by ``rng``,
    in order."""
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
