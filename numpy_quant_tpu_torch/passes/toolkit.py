"""Shared graph-matching toolkit for the optimization passes: a
name->producer map, a consumer scan, and constant extraction (scalars and
whole arrays) that sees through the PTQ pass's quantization of exporter
constants. The passes
operate on the port's own IR (``graph.py``).
"""
from __future__ import annotations

import functools

import numpy as np

import torch

from ..graph import Constant, Node
from ..tensor import FTensor, QTensor

# Ops through which the int8_dataflow pass propagates an early-quantized
# value unchanged (value-preserving shape/layout ops): the op's output
# carries the same numbers as its input, so identical calibrated qparams
# upstream and downstream make early quantization a pure layout change.
PASSTHROUGH_OPS = ("Reshape", "Transpose", "Identity", "Squeeze",
                   "Unsqueeze", "Flatten", "Gather")


def drops_graphs(graph_pass):
    """A pass that rewrites the model: its captured forwards
    (``Model.invalidate_graphs``) go after it, as JAX's passes clear its
    jit cache."""
    @functools.wraps(graph_pass)
    def run(model, *args, **kwargs):
        try:
            return graph_pass(model, *args, **kwargs)
        finally:
            model.invalidate_graphs()
    return run


def host_array(x) -> np.ndarray:
    """A payload (host array, number or device tensor) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def producer_map(model) -> dict[str, Node]:
    """value-name -> producing node, built once per pass invocation.

    Node REMOVALS during a pass leave stale entries behind -- matching
    code must tolerate that exactly like the original inline maps did
    (a removed node no longer sits in ``model.nodes`` but may still be
    returned here; all current matchers only look back through chains
    that are removed atomically with their anchor, so a stale hit
    cannot produce a second match on the same chain).
    """
    produced = {}
    for node in model.nodes:
        for out in node.outputs:
            produced[out.name] = node
    return produced


def consumers(model, value) -> list[Node]:
    """Nodes currently in the graph that consume ``value`` (live scan:
    reflects removals immediately, unlike :func:`producer_map`)."""
    return [n for n in model.nodes if value in n.inputs]


def perm_is(node: Node, perm: tuple) -> bool:
    """True if a Transpose node's ``perm`` attribute equals ``perm``."""
    return tuple(int(p) for p in node.attrs.get("perm", ())) == perm


def dequant_const_array(value) -> np.ndarray | None:
    """A Constant value's payload as the float array the executor sees
    (dequantized if the PTQ pass quantized it), or None."""
    if not isinstance(value, Constant) or value.data is None:
        return None
    d = value.data
    if isinstance(d, QTensor):
        return host_array(d.dequantize().data)
    if isinstance(d, FTensor):
        return host_array(d.data)
    return None


def scalar_const(produced: dict, value) -> float | None:
    """The scalar the EXECUTOR computes for this graph value, or None.

    Three forms, matching what exporters and the PTQ pass produce:

    * a Constant NODE's ``value`` attr (torch exporters emit sqrt2 / 1 /
      0.5 this way -- exact floats),
    * an initializer ``Constant`` holding an ``FTensor``,
    * an initializer the PTQ pass quantized (``QTensor``): returns its
      DEQUANTIZED value -- exactly what the unfused executor would feed
      the op, so matching on it keeps fusions bit-identical.
    """
    prod = produced.get(getattr(value, "name", None))
    if prod is not None and prod.op == "Constant":
        arr = np.asarray(prod.attrs["value"])
        return float(arr.reshape(-1)[0]) if arr.size == 1 else None
    if not isinstance(value, Constant) or value.data is None:
        return None
    d = value.data
    arr = host_array(d.data)
    if arr.size != 1:
        return None
    v = float(arr.reshape(-1)[0])
    if isinstance(d, QTensor):
        if d.zero_point is not None:
            v -= float(host_array(d.zero_point).reshape(-1)[0])
        v *= float(np.float32(d.scale))
    return v
