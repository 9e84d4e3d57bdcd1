"""Model serving shapes: how a Model/QModel forward is driven in production
(port of ``numpy_quant_tpu/serving.py``).

* :func:`map_batches` -- throughput over a fixed dataset: every step
  enqueued on the device with no host sync between them, one sync at the
  end (the counterpart of JAX's ``lax.scan`` over forwards: on CUDA each
  step is one replay of the captured forward, model.py).
* :func:`serve_stream` -- online pipelined stream: up to ``depth`` forwards
  in flight, results yielded in order. A replay returns fresh output
  tensors, so the forwards in flight never share an output buffer.

JAX's ``serve_ring`` (one persistent program pulling batches through host
callbacks inside a ``while_loop``) has no counterpart here:
``Model.serve_ring`` raises ``NotImplementedError``.
"""
from __future__ import annotations

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
