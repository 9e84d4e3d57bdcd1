"""Horizontal matmul merge (port of
``numpy_quant_tpu/passes/matmul_merge.py``): MatMuls sharing one activation
input become one wide product plus in-graph splitting (the ViT Q/K/V
projection pattern). ``QModel.optimize()`` runs it under a tensor-parallel
mesh, as the JAX package gates it."""
from __future__ import annotations

import numpy as np
import torch

from ..graph import Constant, Node
from ..tensor import QTensor


def merge_parallel_matmuls(model) -> int:
    """Fuse the MatMul nodes that share one activation input and take
    per-tensor symmetric 2-D weights of one width and one K into one
    ``MatMulSplit`` node: the weights concatenate along N, the merged
    weight carries a per-column scale vector, and each output segment
    keeps its source's scalar scale, so every value downstream equals the
    unmerged graph's bit for bit. Merged weights inherit their first
    source weight's sharding rule. Returns the number of merged groups."""
    from ..model import QuantizationParams

    groups: dict[int, list[Node]] = {}
    order = {id(n): i for i, n in enumerate(model.nodes)}
    for node in model.nodes:
        if node.op != "MatMul" or len(node.inputs) != 2:
            continue
        w = node.inputs[1]
        if not isinstance(w, Constant) or not isinstance(w.data, QTensor):
            continue
        qt = w.data
        if qt.data.ndim != 2 or qt.zero_point is not None:
            continue
        if getattr(qt.scale, "ndim", 0) > 0:
            continue  # per-channel weights: scales are already vectors
        if len(w.outputs) != 1:
            continue  # weight shared by several nodes
        groups.setdefault(id(node.inputs[0]), []).append(node)

    merged = 0
    for nodes in groups.values():
        first = nodes[0].inputs[1].data
        nodes = [n for n in nodes
                 if n.inputs[1].data.data.shape[0] == first.data.shape[0]
                 and n.inputs[1].data.bit_width == first.bit_width]
        if len(nodes) < 2:
            continue
        nodes.sort(key=lambda n: order[id(n)])
        x_val = nodes[0].inputs[0]
        weights = [n.inputs[1].data for n in nodes]
        segs = [int(w.data.shape[1]) for w in weights]
        seg_scales = [float(np.float32(w.scale)) for w in weights]
        wdata = torch.cat([w.data for w in weights], dim=1)
        scale_vec = np.concatenate(
            [np.full((1, s), np.float32(sc), np.float32)
             for s, sc in zip(segs, seg_scales)], axis=1)
        mname = f"{nodes[0].name}/merged_w"
        mconst = Constant(mname, [], QTensor(wdata, weights[0].bit_width,
                                             scale_vec, None))
        model.quant_params[mname] = QuantizationParams(scale_vec, None)
        fnode = Node(f"{nodes[0].name}/merged", "MatMulSplit",
                     {"segments": segs, "segment_scales": seg_scales,
                      # the source initializers, so exports re-slice
                      # their payloads out of the merged tensor
                      "source_weights": [n.inputs[1].name for n in nodes]},
                     [x_val, mconst], [n.outputs[0] for n in nodes])
        mconst.outputs = [fnode]
        idx = model.nodes.index(nodes[0])
        model.nodes[idx] = fnode
        for n in nodes[1:]:
            model.nodes.remove(n)
        x_val.outputs = list(dict.fromkeys(
            fnode if n in nodes else n for n in x_val.outputs))
        for n in nodes:
            old_w = n.inputs[1]
            if old_w in model.values:
                model.values.remove(old_w)
            n.outputs[0].inputs = [fnode]
        model.values.append(mconst)
        merged += 1

    if merged:
        if "MatMulSplit" not in model.quantized_ops:
            model.quantized_ops = tuple(model.quantized_ops) \
                + ("MatMulSplit",)
        rules = getattr(model, "_shard_rules", None)
        if rules is not None:
            src_of = {node.inputs[1].name: node.attrs["source_weights"][0]
                      for node in model.nodes
                      if node.op == "MatMulSplit"
                      and "source_weights" in node.attrs}

            def merged_rules(name, ndim, _orig=rules, _map=src_of):
                return _orig(_map.get(name, name), ndim)

            model._shard_rules = merged_rules
        model.invalidate_params()
    return merged
