"""GELU fusion pass: the exporter's exact-GELU five-node chain becomes
one FusedGelu node (ops/registry.py executes it: the chain's op
sequence in f32 mode, the sigmoid-form tanh approximation in the bf16
serving mode)."""
from __future__ import annotations

import numpy as np

from ..graph import Constant, Node
from .toolkit import (consumers as _consumers, drops_graphs, producer_map,
                      scalar_const)


@drops_graphs
def fuse_gelu(model) -> int:
    """Fuse the exporter's exact-GELU chain
    Div(x, sqrt2) -> Erf -> Add(1) -> Mul(x, .) -> Mul(., 0.5)
    into ONE FusedGelu node. In f32 mode the node replays the same op
    sequence; in the bf16 serving mode it computes
    x * sigmoid(K1*x + K3*x^3), where the +1 / x0.5 fold into the
    identity 0.5*(1+tanh(z)) == sigmoid(2z). Returns the number of
    fused chains."""
    producer = producer_map(model)

    def consumers(value):
        return _consumers(model, value)

    fused = 0
    for erf in [n for n in model.nodes if n.op == "Erf"]:
        div = producer.get(erf.inputs[0].name)
        if div is None or div.op not in ("Div", "Mul"):
            continue
        c = scalar_const(producer, div.inputs[1])
        via_div = div.op == "Div"
        # the GELU constant (sqrt2 / its reciprocal), allowing the PTQ
        # pass's int8 rounding of the scalar (up to ~1%)
        target = np.sqrt(2.0) if via_div else 1 / np.sqrt(2.0)
        if c is None or abs(c - target) > 0.02 * target:
            continue
        x_val = div.inputs[0]
        cons = consumers(erf.outputs[0])
        if len(cons) != 1 or cons[0].op != "Add":
            continue
        add = cons[0]
        one_val = add.inputs[1] if add.inputs[0] is erf.outputs[0] \
            else add.inputs[0]
        one = scalar_const(producer, one_val)
        if one is None or abs(one - 1.0) > 0.01:
            continue
        cons2 = consumers(add.outputs[0])
        if len(cons2) != 1 or cons2[0].op != "Mul":
            continue
        mul1 = cons2[0]
        m_other = mul1.inputs[1] if mul1.inputs[0] is add.outputs[0] \
            else mul1.inputs[0]
        if m_other is not x_val:
            continue
        cons3 = consumers(mul1.outputs[0])
        if len(cons3) != 1 or cons3[0].op != "Mul":
            continue
        mul2 = cons3[0]
        half_val = mul2.inputs[1] if mul2.inputs[0] is mul1.outputs[0] \
            else mul2.inputs[0]
        half = scalar_const(producer, half_val)
        if half is None or abs(half - 0.5) > 0.005:
            continue
        if any(len(consumers(v)) != 1
               for v in (div.outputs[0], mul1.outputs[0])):
            continue
        # constants ride as INPUTS so the executor dequantizes them
        # through the normal path -- the exact-mode replay is then
        # bitwise identical in every numerics mode (f32 and x64)
        fnode = Node(f"{mul2.name}/fused_gelu", "FusedGelu",
                     {"via_div": via_div,
                      # exactly-1/0.5 constants make the sigmoid
                      # identity pure: y = x * sigmoid(z), no affine
                      # correction passes
                      "pure": one == 1.0 and half == 0.5},
                     [x_val, div.inputs[1], one_val, half_val],
                     [mul2.outputs[0]])
        idx = model.nodes.index(mul2)
        model.nodes[idx] = fnode
        for dead in (div, erf, add, mul1):
            model.nodes.remove(dead)
        x_val.outputs = [fnode if n in (div, mul1) else n
                         for n in x_val.outputs]
        x_val.outputs = list(dict.fromkeys(x_val.outputs))
        for cv in (div.inputs[1], one_val, half_val):
            cv.outputs = [fnode if n in (div, add, mul2) else n
                          for n in cv.outputs]
            cv.outputs = list(dict.fromkeys(cv.outputs))
        mul2.outputs[0].inputs = [fnode]
        fused += 1
    return fused
