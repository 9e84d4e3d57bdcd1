"""Model serving shapes: how a Model/QModel forward is driven in production
(port of ``numpy_quant_tpu/serving.py``).

* :func:`map_batches` -- throughput over a fixed dataset: every step
  enqueued on the device with no host sync between them, one sync at the
  end (the counterpart of JAX's ``lax.scan`` over forwards: on CUDA each
  step is one replay of the captured forward, model.py).
* :func:`serve_stream` -- online pipelined stream: up to ``depth`` forwards
  in flight, results yielded in order. A replay returns fresh output
  tensors, so the forwards in flight never share an output buffer.

* :func:`serve_ring` -- a session over a live feed that the device paces:
  on CUDA each batch is one replay of the signature's captured forward, fed
  from a ring of pinned host buffers and read back into pinned ones
  (JAX's is one persistent program pulling batches through host
  callbacks); :func:`ring_supported` probes that the runtime completes
  the shape.
"""
from __future__ import annotations

import os
import subprocess
import sys
from collections import deque
from typing import List

import numpy as np
import torch


def _is_int64(a) -> bool:
    return (a.dtype == torch.int64 if isinstance(a, torch.Tensor)
            else np.dtype(getattr(a, "dtype", type(a))) == np.int64)


def _finish(outs: list, as_numpy: bool) -> list:
    return [o.cpu().numpy() for o in outs] if as_numpy else list(outs)


@torch.inference_mode()
def map_batches(model, inputs: List[np.ndarray], as_numpy: bool = True):
    """Throughput inference over a leading STEPS axis: each input is
    ``[steps, *per_call_shape]``. The inputs move to the device once, every
    step's forward is enqueued without a host sync, and the outputs come
    back stacked ``[steps, ...]`` after one sync at the end. Float inputs
    only (int64 inputs are shape-domain values, as in the JAX package)."""
    if any(_is_int64(a) for a in inputs):
        raise ValueError("map_batches supports float inputs only "
                         "(int64 inputs are shape-domain)")
    placed = [model._device_tensor(a) for a in inputs]
    steps = placed[0].shape[0] if placed else 0
    outs = [model([a[i] for a in placed], as_numpy=False)
            for i in range(steps)]
    stacked = [torch.stack(list(col)) for col in zip(*outs)]
    return _finish(stacked, as_numpy)


def serve_stream(model, batches, depth: int = 2, as_numpy: bool = True):
    """Pipelined request-stream inference: a generator yielding one output
    list per input batch (in order), keeping up to ``depth`` forwards in
    flight. A forward returns device tensors without waiting for the
    device, so the next batch is enqueued before the previous one's
    results are read back. ``batches``: an iterable of input lists, each as
    ``__call__``'s ``inputs``."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    inflight: deque = deque()
    for batch in batches:
        inflight.append(model(list(batch), as_numpy=False))
        if len(inflight) >= depth:
            yield _finish(inflight.popleft(), as_numpy)
    while inflight:
        yield _finish(inflight.popleft(), as_numpy)


# the feed's batches a ring holds in pinned host memory: the one a replay's
# input copy may still read, and the one the host fills meanwhile
RING_DEPTH = 2

_RING_PROBE_CACHE: dict = {}


class _GraphRing:
    """A captured graph fed from a ring of pinned host buffers: ``launch``
    copies a staged batch into the graph's input buffers and replays it,
    then copies the outputs into pinned host buffers, all on the current
    stream in that order (the copy of batch k+1 waits there for replay k
    to finish reading the inputs); ``read`` waits for one slot's event."""

    def __init__(self, graph, inputs: list, outputs: list, on_replay=None):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.on_replay = on_replay
        self.staged = [[torch.empty(t.shape, dtype=t.dtype,
                                    pin_memory=True) for t in inputs]
                       for _ in range(RING_DEPTH)]
        # a host-domain output (shape math) is the same every replay
        self.host = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                      if isinstance(t, torch.Tensor) else np.asarray(t)
                      for t in outputs] for _ in range(RING_DEPTH)]
        self.done = [torch.cuda.Event() for _ in range(RING_DEPTH)]

    def launch(self, slot: int, batch: list) -> None:
        for buf, a in zip(self.staged[slot], batch):
            buf.numpy()[...] = a
        for dst, src in zip(self.inputs, self.staged[slot]):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        if self.on_replay is not None:
            self.on_replay()
        for dst, src in zip(self.host[slot], self.outputs):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src, non_blocking=True)
        self.done[slot].record()

    def read(self, slot: int) -> list:
        self.done[slot].synchronize()
        return [t.numpy().copy() if isinstance(t, torch.Tensor)
                else t.copy() for t in self.host[slot]]


class _EagerRing:
    """The same loop on the CPU: ``launch`` walks the forward eagerly."""

    def __init__(self, model):
        self.model = model
        self.outs = [None] * RING_DEPTH

    def launch(self, slot: int, batch: list) -> None:
        self.outs[slot] = self.model(batch, as_numpy=False)

    def read(self, slot: int) -> list:
        return [o.numpy().copy() if isinstance(o, torch.Tensor)
                else np.asarray(o) for o in self.outs[slot]]


def _run_ring(ring, first: list, feed, signature: tuple) -> tuple:
    """(outputs, error): ``first`` launched, then per step batch k+1
    pulled from ``feed`` and launched before output k is read, so the
    device paces the feed and at most one batch is pulled ahead of it. A
    batch whose signature is not ``signature`` ends the session, its error
    returned once every launched batch is read."""
    outputs, error = [], None
    ring.launch(0, first)
    k = 0
    while True:
        nxt = None
        try:
            batch = next(feed)
        except StopIteration:
            batch = None
        if batch is not None:
            arrs = [np.asarray(a) for a in batch]
            got = _signature(arrs)
            if got != signature:
                error = ValueError(
                    f"serve_ring batch signature changed mid-session: "
                    f"expected {signature}, got {got}")
            else:
                nxt = arrs
                ring.launch((k + 1) % RING_DEPTH, nxt)
        outputs.append(ring.read(k % RING_DEPTH))
        if nxt is None:
            return outputs, error
        k += 1


def _signature(arrays: list) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype)) for a in arrays)


def _ring_probe() -> None:
    """The ring's shape at a tiny size, run by :func:`ring_supported` in a
    subprocess: on a card a captured graph replayed from a pinned ring and
    read back, else the eager ring over a plain function. Exits non-zero
    when a result is wrong."""
    if torch.cuda.is_available():
        x = torch.zeros(4, device="cuda")
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            y = x * 2.0 + 1.0
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            y = x * 2.0 + 1.0
        ring = _GraphRing(graph, [x], [y])
    else:
        class _Plain:
            def __call__(self, batch, as_numpy=False):
                return [torch.from_numpy(batch[0]) * 2.0 + 1.0]
        ring = _EagerRing(_Plain())
    feed = [[np.full(4, i, np.float32)] for i in range(5)]
    it = iter(feed)
    first = next(it)
    outs, error = _run_ring(ring, first, it, _signature(first))
    want = [np.full(4, 2.0 * i + 1.0, np.float32) for i in range(5)]
    if error is not None or len(outs) != 5 or any(
            not np.array_equal(o[0], w) for o, w in zip(outs, want)):
        raise SystemExit(1)


def ring_supported(timeout: float = 120.0) -> bool:
    """Whether this runtime completes :func:`serve_ring`'s shape -- a
    captured graph replayed from a ring of pinned host buffers and read
    back -- probed in a subprocess under a watchdog (a hang or an error is
    False). Cached per process; ``NQ_TPU_RING=0/1`` overrides it."""
    forced = os.environ.get("NQ_TPU_RING")
    if forced is not None:
        return forced == "1"
    hit = _RING_PROBE_CACHE.get("ok")
    if hit is not None:
        return hit
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    code = ("if __name__ == '__main__':\n"
            "    from numpy_quant_tpu_torch.serving import _ring_probe\n"
            "    _ring_probe()\n")
    try:
        r = subprocess.run([sys.executable, "-c", code], timeout=timeout,
                           capture_output=True, env=env)
        ok = r.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        ok = False
    _RING_PROBE_CACHE["ok"] = ok
    return ok


def serve_ring(model, batches, probe: bool = True) -> list:
    """Serve a live feed: ``batches`` (an iterable, e.g. a generator, of
    input lists as ``__call__`` takes them, all of the first one's shapes
    and dtypes) in one session; returns the per-batch output lists (host
    numpy) in order, each equal to ``model(batch)``'s.

    On CUDA every batch replays the signature's captured forward (the one
    ``__call__`` keeps, captured here on first use): batch k+1 is pulled
    after replay k is enqueued and before output k is read back, staged
    through pinned buffers (:data:`RING_DEPTH` of them) into the graph's
    input buffers on the replay's stream; outputs come back through pinned
    buffers, one host wait per batch. On the CPU the same loop walks
    eagerly. Float inputs only; not on a sharded model. A mid-session
    signature change ends the session and raises once it has wound down.
    ``probe=True`` first checks :func:`ring_supported` and raises
    ``RuntimeError`` if the runtime fails it; ``probe=False`` skips it."""
    if model.mesh is not None:
        raise ValueError("serve_ring runs on one device; use map_batches "
                         "on a sharded model")
    if probe and not ring_supported():
        raise RuntimeError(
            "serve_ring: this runtime does not complete a captured graph "
            "replayed from a pinned input ring; serve with map_batches or "
            "serve_stream instead")
    feed = iter(batches)
    try:
        first = [np.asarray(a) for a in next(feed)]
    except StopIteration:
        return []
    if any(_is_int64(a) for a in first):
        raise ValueError("serve_ring supports float inputs only (int64 "
                         "inputs are shape-domain)")
    signature = _signature(first)
    key = ("serve_ring", signature, str(model.device))
    if key in model._ring_state:
        raise RuntimeError("a serve_ring session with this input signature "
                           "is already running on this model")
    model._ring_state[key] = True
    try:
        with torch.inference_mode():
            if model.device.type == "cuda":
                entry, _ = model._captured(first)
                from . import kernels
                ring = _GraphRing(
                    entry.graph,
                    [entry.inputs[i] for i in sorted(entry.inputs)],
                    entry.outputs,
                    lambda: kernels.add_launch_counts(entry.launches))
                with torch.cuda.device(model.device):
                    outputs, error = _run_ring(ring, first, feed, signature)
            else:
                ring = _EagerRing(model)
                outputs, error = _run_ring(ring, first, feed, signature)
    finally:
        del model._ring_state[key]
    if error is not None:
        raise error
    return outputs
