"""The benchmark's cells at a size a CPU test run holds: every width cut,
the same code paths. Used by the CPU tests only."""
from __future__ import annotations

import time

import torch

from benchmark.common import harness


def shrink(cell: harness.Cell) -> harness.Cell:
    if cell.spec["model_type"] == "vit":
        cell.spec.update(hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         image_size=32, patch_size=16, num_labels=10)
        cell.spec["precision"]["float_dtype"] = "float32"
        cell.mix.update(batch=4, distinct=2)
    else:
        cell.spec.update(vocab_size=4096, n_embd=128, n_layer=2, n_head=4,
                         n_positions=128)
        cell.spec["serving"].update(slots=8, cache_len=96, prefill_len=16)
        # a closed backlog judges only what finishes inside the short
        # window: shorter answers there
        short = cell.mix["load"] == "closed"
        for part, lo, hi in (("prompt", 4, 16),
                             ("output", 8 if short else 16,
                              32 if short else 64)):
            d = cell.mix[part]
            d.update(min=lo, max=hi)
            if "median" in d:
                d["median"] = (lo + hi) // 2
        if cell.mix["load"] == "open":
            cell.mix.update(rate=20.0, drain_s=30)
        else:
            cell.mix.update(queue=8, pool=512)
        cell.mix["check_tokens"] = 600
    return cell


def cell(name: str, root: str = harness.ROOT) -> harness.Cell:
    return shrink(harness.Cell.find(name, root))


def run(c: harness.Cell, seed: int = 12345678901, seconds: float = 1.5):
    """(record, checks, correct) of one CPU run of ``c``."""
    record, _, _, checks = harness.measure(
        c, seed, seconds, False, torch.device("cpu"), time.perf_counter())
    return record, checks, all(v <= lim for _, v, lim in checks)
