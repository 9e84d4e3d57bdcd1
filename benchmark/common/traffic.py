"""The one generator of every traffic mix: it reads a mix's parameters
(``benchmark/traffic/<mix>.json``) and makes its inputs from the run's seed.

A mix names its pieces, each a file found by its name: the arrival process
``benchmark/arrivals/<arrivals>.py`` (a ``due(mix, shape, order,
seconds)`` of due times) and each length distribution
``benchmark/lengths/<dist>.py`` (a ``draw(dist, n, rng)``). A new process
or distribution is a new file, and no file here changes.

The set of sizes and of arrival gaps comes from the mix's own
``shape_seed``, the same for every run seed; the run seed orders them
(whole, or in blocks of the mix's ``order_block``) and draws the contents
(token ids, pixels). So every seed asks for the same work, in another
order."""
from __future__ import annotations

import os
import zlib
from dataclasses import dataclass

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LOADED = {}


def piece(group: str, name: str, bench: str = BENCH):
    """The module ``<bench>/<group>/<name>.py`` (an arrival process, a
    length distribution, a loop), loaded once."""
    from .harness import load_module
    path = os.path.join(bench, group, name + ".py")
    if path not in _LOADED:
        _LOADED[path] = load_module(path, f"bench_{group}_{name}")
    return _LOADED[path]


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of the run seed: one
    independent stream per use (weights, calibration, images, ...)."""
    seq = np.random.SeedSequence(int(seed) % 2 ** 64,
                                 spawn_key=(zlib.crc32(name.encode()),))
    return int(seq.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def lengths(dist: dict, n: int, rng: np.random.Generator,
            bench: str = BENCH) -> np.ndarray:
    """``n`` whole lengths drawn as ``dist`` says: its ``dist`` names the
    file under ``benchmark/lengths/``."""
    return np.asarray(piece("lengths", dist["dist"], bench).draw(
        dist, n, rng)).astype(np.int64)


@dataclass
class Request:
    index: int
    due: float            # seconds after the window opens (0: backlog)
    prompt: np.ndarray    # int32 token ids
    max_new: int


def shuffled(order: np.random.Generator, n: int, mix: dict) -> np.ndarray:
    """A permutation of ``range(n)`` drawn by ``order`` within each block
    of the mix's ``order_block`` (0 or absent: one block), so that each
    block keeps its own set of sizes or gaps whatever the seed."""
    block = int(mix.get("order_block", 0)) or max(n, 1)
    return np.concatenate(
        [i + order.permutation(min(block, n - i)) for i in range(0, n, block)]
        or [np.zeros(0, np.int64)]).astype(np.int64)


def requests(mix: dict, seed: int, vocab: int, seconds: float,
             bench: str = BENCH) -> list:
    """The requests of a ``requests`` mix over a window of ``seconds``:
    due times from its ``arrivals`` process, prompt and output lengths
    from its ``prompt`` and ``output`` distributions (drawn from the
    mix's ``shape_seed``, then ordered by the run seed), token ids drawn
    from the run seed."""
    shape = np.random.default_rng(mix["shape_seed"])
    order = np.random.default_rng(stream_seed(seed, "order"))
    due = np.asarray(piece("arrivals", mix["arrivals"], bench).due(
        mix, shape, order, seconds), dtype=np.float64)
    n = due.size
    plen = lengths(mix["prompt"], n, shape, bench)
    olen = lengths(mix["output"], n, shape, bench)
    perm = shuffled(order, n, mix)
    plen, olen = plen[perm], olen[perm]
    run = np.random.default_rng(stream_seed(seed, "requests"))
    ids = run.integers(0, vocab, size=int(plen.sum()), dtype=np.int64)
    cuts = np.cumsum(plen)[:-1]
    return [Request(i, float(d), p.astype(np.int32), int(o))
            for i, (d, p, o) in enumerate(zip(due, np.split(ids, cuts),
                                              olen))]


def images(mix: dict, seed: int, image_shape: tuple, device,
           stream: str = "images"):
    """``mix['distinct']`` batches of ``mix['batch']`` images
    [distinct, batch, *image_shape], float32 normal(0, ``image_std``),
    drawn on ``device`` in one call from the run seed."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    shape = (int(mix["distinct"]), int(mix["batch"])) + tuple(image_shape)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.normal_(0.0, float(mix["image_std"]), generator=gen)
    return x
