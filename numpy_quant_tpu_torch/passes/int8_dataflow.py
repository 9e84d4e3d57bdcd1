"""Early-int8 activation layout pass: values every consumer quantizes
anyway are produced as int8 QTensors at their producer, so the residual
stream stays int8 in device memory. A pure layout change -- same
quantize(), same qparams, identical outputs."""
from __future__ import annotations

import numpy as np

from .toolkit import PASSTHROUGH_OPS, drops_graphs


@drops_graphs
def int8_dataflow(model) -> int:
    """Plan EARLY quantization: a value whose consumers all quantize it
    anyway -- quantized ops directly, or value-preserving shape ops
    leading only to such consumers with identical calibrated qparams --
    is produced as an int8 QTensor at its producer instead of a float
    tensor. The same quantize() with the same qparams runs once at the
    producer instead of per consumer, so outputs are unchanged.

    Returns the number of values planned. Run AFTER fuse_attention().
    """
    out_names = {o.name for o in model.outputs}
    qp = model.quant_params

    def scalar_qp(name):
        p = qp.get(name)
        if p is None or p.scale is None:
            return None
        if getattr(p.scale, "ndim", 0) > 0:
            return None  # per-channel scales stay on the float path
        if float(np.float32(p.scale)) == 0.0:
            return None  # degenerate (constant-valued activation)
        return p

    def qp_equal(a, b):
        if a is None or b is None:
            return False
        if np.float32(a.scale) != np.float32(b.scale):
            return False
        if (a.zero_point is None) != (b.zero_point is None):
            return False
        return a.zero_point is None or int(a.zero_point) == int(b.zero_point)

    planned: set[str] = set()
    # nodes are topologically ordered; walking them in reverse decides
    # every passthrough consumer's outputs before its inputs
    for node in reversed(model.nodes):
        for value in node.outputs:
            if value.name in out_names or not value.outputs:
                continue
            p = scalar_qp(value.name)
            if p is None:
                continue
            ok = True
            for consumer in value.outputs:
                if consumer.op == "Shape":
                    # metadata-only consumer: Shape reads dims, never
                    # data, and handles QTensor directly
                    continue
                if consumer.op in model.quantized_ops:
                    # only operand positions that quantize at the model
                    # bit width (never a Gemm bias)
                    if consumer.op == "Gemm" and len(consumer.inputs) > 2 \
                            and consumer.inputs[2] is value:
                        ok = False
                        break
                    continue
                if consumer.op in PASSTHROUGH_OPS \
                        and consumer.inputs[0] is value \
                        and all(o.name in planned
                                and qp_equal(p, scalar_qp(o.name))
                                for o in consumer.outputs):
                    continue
                ok = False
                break
            if ok:
                planned.add(value.name)
    # fused-attention nodes with planned outputs requantize inside the
    # kernel epilogue (no separate quantize pass)
    for node in model.nodes:
        if node.op in ("FusedAttention", "FusedAttentionHS") \
                and node.outputs[0].name in planned:
            p = qp[node.outputs[0].name]
            node.attrs["out_requant"] = (
                float(np.float32(p.scale)),
                None if p.zero_point is None else int(p.zero_point))
    model._int8_values = planned
    return len(planned)
