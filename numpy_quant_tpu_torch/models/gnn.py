"""GNN (GCN-style) graph generators (port of
``numpy_quant_tpu/models/gnn.py``; the same arguments give the JAX
package's serialized graph byte for byte):

* ``gcn_dense``  -- normalized dense adjacency: layer = Act(A_hat@X@W+b).
  Both matmuls quantize (A_hat and W are initializers, X and the hidden
  activations calibrate), so message passing runs as integer products.
* ``gcn_scatter`` -- edge-list form: Gather source-node features per
  edge, ScatterElements(reduction='add') into destinations, then a
  quantized MatMul + bias, with int64 edge indices as a host input.
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder


def _random_graph(n_nodes: int, n_edges: int, rng):
    src = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    return src, dst


def _normalized_adjacency(n_nodes, src, dst) -> np.ndarray:
    a = np.zeros((n_nodes, n_nodes), dtype=np.float32)
    a[dst, src] = 1.0
    a += np.eye(n_nodes, dtype=np.float32)  # self loops
    deg = a.sum(axis=1, keepdims=True)
    return (a / np.sqrt(deg) / np.sqrt(deg.T)).astype(np.float32)


def gcn_dense(n_nodes: int, n_edges: int, in_feat: int, hidden: int,
              n_classes: int, seed: int = 0) -> O.ModelProto:
    """2-layer GCN with dense normalized adjacency (all-matmul)."""
    rng = np.random.default_rng(seed)
    src, dst = _random_graph(n_nodes, n_edges, rng)
    a_hat = _normalized_adjacency(n_nodes, src, dst)
    w1 = (rng.standard_normal((in_feat, hidden)) / np.sqrt(in_feat)).astype(np.float32)
    b1 = rng.standard_normal(hidden).astype(np.float32) * 0.1
    w2 = (rng.standard_normal((hidden, n_classes)) / np.sqrt(hidden)).astype(np.float32)
    b2 = rng.standard_normal(n_classes).astype(np.float32) * 0.1

    g = GraphBuilder("gcn_dense")
    x = g.input("features", [n_nodes, in_feat])
    g.init("a_hat", a_hat)
    g.init("w1", w1)
    g.init("b1", b1)
    g.init("w2", w2)
    g.init("b2", b2)
    m1 = g.node("MatMul", ["a_hat", x], out="/agg1")
    h1 = g.node("MatMul", [m1, "w1"], out="/proj1")
    h1b = g.node("Add", [h1, "b1"], out="/bias1")
    r1 = g.node("Relu", [h1b], out="/relu1")
    m2 = g.node("MatMul", ["a_hat", r1], out="/agg2")
    h2 = g.node("MatMul", [m2, "w2"], out="/proj2")
    g.node("Add", [h2, "b2"], out="logits")
    g.output("logits", [n_nodes, n_classes])
    model = g.model()
    model._weights = dict(a_hat=a_hat, w1=w1, b1=b1, w2=w2, b2=b2)
    return model


def gcn_scatter(n_nodes: int, n_edges: int, in_feat: int, n_classes: int,
                seed: int = 0) -> O.ModelProto:
    """1-layer message-passing GCN in edge-list form:
    h = Relu((scatter_add(gather(X, src) -> dst) + X) @ W + b)."""
    rng = np.random.default_rng(seed)
    src, dst = _random_graph(n_nodes, n_edges, rng)
    w = (rng.standard_normal((in_feat, n_classes)) / np.sqrt(in_feat)).astype(np.float32)
    b = rng.standard_normal(n_classes).astype(np.float32) * 0.1

    g = GraphBuilder("gcn_scatter")
    x = g.input("features", [n_nodes, in_feat])
    g.input("src", [n_edges], elem_type=O.TensorProto.INT64)
    g.init("w", w)
    g.init("b", b)
    g.init("dst_expanded",
           np.broadcast_to(dst[:, None], (n_edges, in_feat)).copy())
    zeros = g.init("zeros", np.zeros((n_nodes, in_feat), dtype=np.float32))
    msgs = g.node("Gather", [x, "src"], out="/messages", axis=0)
    agg = g.node("ScatterElements", [zeros, "dst_expanded", msgs],
                 out="/aggregated", axis=0, reduction="add")
    tot = g.node("Add", [agg, x], out="/with_self")
    proj = g.node("MatMul", [tot, "w"], out="/proj")
    g.node("Add", [proj, "b"], out="logits")
    g.output("logits", [n_nodes, n_classes])
    model = g.model()
    model._weights = dict(w=w, b=b, src=src, dst=dst)
    return model
