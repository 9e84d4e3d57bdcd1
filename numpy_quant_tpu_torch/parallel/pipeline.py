"""Pipeline parallelism (GPipe) over a ``pipe`` mesh axis (port of
``numpy_quant_tpu/parallel/pipeline.py``).

* :func:`split_stages` cuts a model's node list into S contiguous stages
  at single-value cut points whose crossing activation has the one
  dominant shape (the residual stream), balanced by parameter bytes; the
  cut points equal the JAX package's node for node. QModel stages cut
  only at values that execute as float, and interior stages carry that
  activation as it is (no entry quantize, no exit dequantize), so the
  pipelined int8 model runs the unpipelined op sequence.
* :func:`pipeline_forward`: rank s of the pipe axis runs stage s; the
  batch streams through as M microbatches over ``M + S - 1`` steps, each
  activation handed to the next stage by ``send``/``recv``; the last
  stage broadcasts the stacked output (JAX psums it), so every rank
  returns it.
* :func:`pipeline_forward_stagewise`: PP x TP. Stage s runs as its own
  tensor-parallel model on the mesh's pipe row s (a ``("model",)``
  sub-mesh); activations hop from each rank of row s to the rank at the
  same model index of row s + 1.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..graph import Constant, Node, Variable
from . import mesh as M


def _clone_segment(nodes: list, boundary_in, boundary_out):
    """Deep-clone a node segment into a fresh sub-graph (payloads shared).
    Returns (nodes, values, input_var, output_var)."""
    vmap: dict = {}

    def clone_value(v):
        c = vmap.get(id(v))
        if c is None:
            if isinstance(v, Constant):
                c = Constant(v.name, [], v.data)
            else:
                c = Variable(v.name, [], [], v.data)
                c.shape_hint = getattr(v, "shape_hint", None)
                c.dtype_hint = getattr(v, "dtype_hint", None)
            vmap[id(v)] = c
        return c

    new_nodes = []
    for n in nodes:
        nn = Node(n.name, n.op, dict(n.attrs),
                  [clone_value(v) if v is not None else None
                   for v in n.inputs],
                  [clone_value(v) for v in n.outputs])
        for v in nn.inputs:
            if v is not None:
                v.outputs.append(nn)
        for v in nn.outputs:
            v.inputs.append(nn)
        new_nodes.append(nn)
    values = list(vmap.values())
    return (new_nodes, values, vmap[id(boundary_in)],
            vmap[id(boundary_out)])


def _nbytes(data) -> int:
    d = data.data
    if isinstance(d, torch.Tensor):
        return d.numel() * d.element_size()
    return np.asarray(d).nbytes


def split_stages(model, n_stages: int) -> list:
    """Split ``model`` into ``n_stages`` sub-models at single-value cut
    points whose crossing activation has the dominant shape, balancing
    parameter bytes per stage. The model has one input and one output."""
    from ..model import Model, QModel

    is_q = getattr(model, "quant_params", None) is not None
    if len(model.inputs) != 1 or len(model.outputs) != 1:
        raise ValueError("pipeline stages carry ONE activation; the "
                         "model must have a single input and output "
                         f"(got {len(model.inputs)}/{len(model.outputs)})")
    nodes = model.nodes
    last_use: dict = {}
    for i, n in enumerate(nodes):
        for v in n.inputs:
            if v is not None and isinstance(v, Variable):
                last_use[v.name] = i

    shapes = model._infer_shapes() or {}
    cuts = []
    for i in range(len(nodes) - 1):
        live = [v for n in nodes[:i + 1] for v in n.outputs
                if isinstance(v, Variable)
                and last_use.get(v.name, -1) > i]
        live = list({id(v): v for v in live}.values())
        if len(live) == 1:
            v = live[0]
            if is_q:
                prod = v.inputs[0] if v.inputs else None
                if ((prod is not None and prod.op in model.quantized_ops)
                        or v.name in model._int8_values):
                    continue
            cuts.append((i, v))
    if not cuts:
        raise ValueError("no single-value cut points (the graph is not "
                         "a chain at any node boundary)")
    shape_of = {c[1].name: shapes.get(c[1].name) for c in cuts}
    known = Counter(s for s in shape_of.values() if s is not None)
    if not known:
        raise ValueError("no cut-point shapes could be inferred (the model "
                         "inputs need float shape hints)")
    dominant, _ = known.most_common(1)[0]
    cuts = [c for c in cuts if shape_of[c[1].name] == dominant]
    if len(cuts) < n_stages - 1:
        raise ValueError(f"only {len(cuts)} same-shape cut points for "
                         f"{n_stages} stages")

    def node_bytes(n):
        return sum(_nbytes(v.data) for v in n.inputs
                   if isinstance(v, Constant) and v.data is not None
                   and hasattr(v.data, "data"))

    cum = np.cumsum([node_bytes(n) for n in nodes])
    total = float(cum[-1])
    chosen = []
    ci = 0
    for s in range(1, n_stages):
        target = total * s / n_stages
        while ci < len(cuts) - (n_stages - 1 - s) - 1 \
                and cum[cuts[ci][0]] < target:
            ci += 1
        chosen.append(cuts[ci])
        ci += 1
    bounds = [-1] + [c[0] for c in chosen] + [len(nodes) - 1]
    stage_models = []
    prev_val = model.inputs[0]
    for s in range(n_stages):
        seg = nodes[bounds[s] + 1:bounds[s + 1] + 1]
        out_val = chosen[s][1] if s < n_stages - 1 else model.outputs[0]
        new_nodes, values, vin, vout = _clone_segment(seg, prev_val,
                                                      out_val)
        if getattr(vin, "shape_hint", None) is None:
            vin.shape_hint = shapes.get(prev_val.name)
            vin.dtype_hint = 1  # FLOAT boundary carry
        if is_q:
            sub = QModel(new_nodes, values, [vin], [vout],
                         model.bit_width, model.quant_params,
                         model.quantized_ops, device=model.device,
                         container=model.container)
            sub.requantized_ops = model.requantized_ops
            sub._int8_values = set(model._int8_values)
            sub._passthrough_wrap = s > 0
            sub._passthrough_finalize = s < n_stages - 1
        else:
            sub = Model(new_nodes, values, [vin], [vout], model.device)
        stage_models.append(sub)
        prev_val = out_val
    return stage_models


def _microbatches(x, m: int, device) -> list:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    return list(x.to(device).split(b // m, dim=0))


def pipeline_forward(stage_models: list, mesh, x, out_shape_dtype,
                     n_microbatches: int, pipe_axis: str = "pipe",
                     as_numpy: bool = True):
    """Run ``x`` through the stages as a GPipe pipeline over
    ``mesh[pipe_axis]``: the rank at pipe index s runs stage s, and each
    microbatch's activation goes to the next stage by ``send``/``recv``.
    ``out_shape_dtype``: (shape, dtype) of the whole output. Every rank
    returns the stacked [B, ...] output."""
    S = mesh.shape[pipe_axis]
    if len(stage_models) != S:
        raise ValueError(f"{len(stage_models)} stages != mesh "
                         f"{pipe_axis} size {S}")
    Mb = int(n_microbatches)
    s = mesh.index(pipe_axis)
    _, ranks = mesh.group(pipe_axis)
    dev = mesh.device
    mbs = _microbatches(x, Mb, dev)
    mb = mbs[0].shape[0]
    hint = stage_models[1].inputs[0].shape_hint if S > 1 else None
    if S > 1 and hint is None:
        raise ValueError("stage boundary has no shape hint")
    bshape = (mb,) + tuple(int(d) for d in hint[1:]) if S > 1 else None
    oshape, odtype = out_shape_dtype
    oshape = tuple(int(d) for d in oshape)
    model = stage_models[s]
    outs = []
    for t in range(Mb + S - 1):
        i = t - s
        if not 0 <= i < Mb:
            continue
        if s == 0:
            h = mbs[i]
        else:
            h = M.recv(bshape, torch.float32, ranks[s - 1], dev)
        y = model([h], as_numpy=False)[0]
        if s < S - 1:
            M.send(y.to(torch.float32), ranks[s + 1])  # bf16 -> f32 exact
        else:
            outs.append(y)
    torch_dtype = torch.from_numpy(np.zeros(0, odtype)).dtype
    if s == S - 1:
        out = torch.cat(outs, 0).to(dev, torch_dtype)
    else:
        out = torch.empty(oshape, dtype=torch_dtype, device=dev)
    out = M.broadcast(out, mesh, pipe_axis, S - 1)
    return out.cpu().numpy() if as_numpy else out


def pipeline_forward_stagewise(stage_models: list, mesh, x,
                               n_microbatches: int,
                               pipe_axis: str = "pipe",
                               model_axis: str = "model",
                               rules=None, as_numpy: bool = True):
    """PP x TP: stage s is its own tensor-parallel model on the mesh's
    pipe row s (``rules`` apply over ``model_axis`` inside each stage);
    every rank of row s hands each microbatch's (gathered) activation to
    the rank at its model index in row s + 1, and the last row broadcasts
    the stacked output. Returns the [B, ...] float output on every
    rank."""
    from .sharding import shard_model

    S = mesh.shape[pipe_axis]
    if len(stage_models) != S:
        raise ValueError(f"{len(stage_models)} stages != mesh "
                         f"{pipe_axis} size {S}")
    Mb = int(n_microbatches)
    rows = [mesh.row(pipe_axis, r, (model_axis,)) for r in range(S)]
    s = mesh.index(pipe_axis)
    t_idx = mesh.index(model_axis)
    sm = stage_models[s]
    have = getattr(sm, "mesh", None)
    if have is None or have.axis_names != (model_axis,) \
            or have.devices.tolist() != rows[s].devices.tolist():
        shard_model(sm, rows[s], data_axis=None, rules=rules)
    dev = mesh.device
    mbs = _microbatches(x, Mb, dev)
    model = stage_models[s]
    outs = []
    for i in range(Mb):
        if s == 0:
            h = mbs[i]
        else:
            src = int(rows[s - 1].devices[t_idx])
            shape = (mbs[i].shape[0],) + tuple(
                int(d) for d in model.inputs[0].shape_hint[1:])
            h = M.recv(shape, torch.float32, src, dev)
        y = model([h], as_numpy=False)[0]
        if s < S - 1:
            M.send(y.to(torch.float32), int(rows[s + 1].devices[t_idx]))
        else:
            outs.append(y)
    if s == S - 1:
        out = torch.cat(outs, 0).to(dev)
        shape = torch.tensor(out.shape, dtype=torch.int64)
    else:
        out, shape = None, torch.zeros(8, dtype=torch.int64)
    last = int(mesh.devices.reshape(-1).tolist().index(
        int(rows[S - 1].devices[0])))
    meta = torch.zeros(8, dtype=torch.int64)
    if out is not None:
        meta[0] = out.ndim
        meta[1:1 + out.ndim] = shape
    meta = M.broadcast(meta, mesh, None, last)
    oshape = tuple(int(d) for d in meta[1:1 + int(meta[0])])
    if out is None:
        out = torch.empty(oshape, dtype=torch.float32, device=dev)
    out = M.broadcast(out.to(torch.float32), mesh, None, last)
    return out.cpu().numpy() if as_numpy else out
