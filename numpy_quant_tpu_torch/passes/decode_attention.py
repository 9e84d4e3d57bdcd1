"""Decode-form attention fusion: the KV-cache step graph's
scores_past/scores_self/Concat/.../Softmax/Slice/context chain becomes one
``DecodeAttention`` node (port of
``numpy_quant_tpu/passes/decode_attention.py``).

At the [B, 1, H] decode shape every score and context MatMul has one query
row, and the integer path re-reduces the whole K/V cache every step for
the zero-point correction sums. The fused op (ops/registry.py) computes
the chain in float with the cache dequantize fused into the dot operands
and replays every quantization the unfused executor applies: fake-quant
of q, the caches and the probabilities with the same calibrated params,
dequantize of int8 cache entries, the PTQ-rounded scale constant, the
quantized mask input. Only the dots run in float instead of exact
integers, so a quantized model's results are ulp-equal rather than bit
for bit; a float model's are equal.

Pattern (models/gpt.py ``_decode_attention``; models/llama.py emits the
same shape with RoPE and repeat_kv upstream of qh/kh):

    s_past = MatMul(qh, Transpose(k_cache))        [B,H,1,L]
    s_self = MatMul(qh, Transpose(kh))             [B,H,1,1]
    s      = Concat(s_past, s_self, axis=-1)
    ... Mul(scalar) / Add(mask-or-bias) chain ...
    probs  = Softmax(..., axis=-1)
    p_past = Slice(probs, 0, L, -1); p_self = Slice(probs, L, L+1, -1)
    ctx    = Add(MatMul(p_past, v_cache), Mul(p_self, vh))

One deliberate difference from the JAX pass: where a value the fused op
would fake-quantize carries non-scalar (per-channel) qparams, JAX fuses
and drops that quantize step; the port declines the chain and records the
Softmax with the reason in ``model.fusion_report["failures"]``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph import Constant, Node
from ..tensor import ITensor
from .toolkit import (consumers as _consumers, drops_graphs, producer_map,
                      scalar_const)

_PER_CHANNEL = object()  # qp_attr's mark for non-scalar qparams


def _slice_bounds(node, producer):
    """(start, end, axis) of a Slice with one-element integer constant
    operands (initializers or Constant-node outputs), or None."""
    if node.op != "Slice" or len(node.inputs) < 4:
        return None
    vals = []
    for v in node.inputs[1:4]:
        nd = producer.get(v.name)
        if nd is not None and nd.op == "Constant":
            arr = np.asarray(nd.attrs.get("value"))
        elif isinstance(v, Constant) and isinstance(v.data, ITensor):
            arr = v.data.data
        else:
            return None
        if arr.size != 1 or not np.issubdtype(arr.dtype, np.integer):
            return None
        vals.append(int(arr.reshape(-1)[0]))
    return tuple(vals)


def _epilogue(sm, producer):
    """Walk from the Softmax input up to the Concat through scalar Muls and
    Adds: (concat node, epilogue [("mul", value) | ("add", extra index)]
    in forward order, extra inputs, chain nodes), or a None concat."""
    epilogue, extra_inputs, chain_nodes = [], [], []
    cur = sm.inputs[0]
    for _ in range(6):
        nd = producer.get(cur.name)
        if nd is None:
            break
        if nd.op == "Concat":
            epilogue.reverse()
            return nd, epilogue, extra_inputs, chain_nodes
        if nd.op == "Mul":
            sc = scalar_const(producer, nd.inputs[1])
            other = nd.inputs[0]
            if sc is None:
                sc = scalar_const(producer, nd.inputs[0])
                other = nd.inputs[1]
            if sc is None:
                break
            epilogue.append(("mul", sc))
            chain_nodes.append(nd)
            cur = other
            continue
        if nd.op == "Add":
            # the additive mask or score bias rides as an extra input
            # (graph input or constant)
            other, operand = nd.inputs[0], nd.inputs[1]
            if producer.get(other.name) is None \
                    and not isinstance(other, Constant) \
                    and (producer.get(operand.name) is not None
                         or isinstance(operand, Constant)):
                other, operand = operand, other
            epilogue.append(("add", len(extra_inputs)))
            extra_inputs.append(operand)
            chain_nodes.append(nd)
            cur = other
            continue
        break
    return None, None, None, None


@drops_graphs
def fuse_decode_attention(model) -> int:
    """Fuse decode-step attention chains into DecodeAttention nodes. Works
    on float models and QModels; returns the number fused. Softmaxes it
    fuses leave ``fusion_report["failures"]``; chains it declines enter it
    with the reason."""
    producer = producer_map(model)
    qp_map = getattr(model, "quant_params", None)
    report = model.__dict__.setdefault("fusion_report",
                                       {"fused": 0, "failures": []})

    def consumers(value):
        return _consumers(model, value)

    def qp_attr(value):
        if qp_map is None:
            return None
        p = qp_map.get(value.name)
        if p is None or p.scale is None:
            return None
        if getattr(p.scale, "ndim", 0) > 0 or (
                p.zero_point is not None
                and getattr(p.zero_point, "ndim", 0) > 0):
            return _PER_CHANNEL
        return (float(np.float32(p.scale)),
                None if p.zero_point is None else int(p.zero_point))

    def settle(sm, reason=None):
        report["failures"] = [f for f in report["failures"]
                              if f[0] != sm.name]
        if reason is not None:
            report["failures"].append((sm.name, reason))

    fused = 0
    for sm in [n for n in model.nodes if n.op == "Softmax"]:
        if int(sm.attrs.get("axis", -1)) != -1:
            continue
        concat, epilogue, extra_inputs, chain_nodes = _epilogue(sm, producer)
        if concat is None or len(concat.inputs) != 2 \
                or int(concat.attrs.get("axis", 0)) != -1:
            continue
        sp_nd = producer.get(concat.inputs[0].name)
        ss_nd = producer.get(concat.inputs[1].name)
        if sp_nd is None or ss_nd is None \
                or sp_nd.op != "MatMul" or ss_nd.op != "MatMul" \
                or sp_nd.inputs[0] is not ss_nd.inputs[0]:
            continue                      # both dots share q
        qh = sp_nd.inputs[0]
        ktc_nd = producer.get(sp_nd.inputs[1].name)
        kts_nd = producer.get(ss_nd.inputs[1].name)
        if ktc_nd is None or kts_nd is None \
                or ktc_nd.op != "Transpose" or kts_nd.op != "Transpose" \
                or list(ktc_nd.attrs.get("perm", [])) != [0, 1, 3, 2] \
                or list(kts_nd.attrs.get("perm", [])) != [0, 1, 3, 2]:
            continue
        k_cache, kh = ktc_nd.inputs[0], kts_nd.inputs[0]

        # the probabilities feed the two slices
        cons = consumers(sm.outputs[0])
        if len(cons) != 2:
            continue
        b0, b1 = (_slice_bounds(cons[0], producer),
                  _slice_bounds(cons[1], producer))
        if b0 is None or b1 is None:
            continue
        if b0[0] == 0:
            past_sl, self_sl, pb, sb = cons[0], cons[1], b0, b1
        else:
            past_sl, self_sl, pb, sb = cons[1], cons[0], b1, b0
        cache_len = pb[1]
        if pb != (0, cache_len, -1) or sb[0] != cache_len or sb[2] != -1 \
                or sb[1] <= cache_len:
            continue
        pc = consumers(past_sl.outputs[0])
        sc = consumers(self_sl.outputs[0])
        if len(pc) != 1 or len(sc) != 1:
            continue
        mm2, mulc = pc[0], sc[0]
        if mm2.op != "MatMul" or mm2.inputs[0] is not past_sl.outputs[0] \
                or mulc.op != "Mul":
            continue
        v_cache = mm2.inputs[1]
        vh = mulc.inputs[1] if mulc.inputs[0] is self_sl.outputs[0] \
            else mulc.inputs[0]
        ac = consumers(mm2.outputs[0])
        mc = consumers(mulc.outputs[0])
        if len(ac) != 1 or len(mc) != 1 or ac[0].op != "Add" \
                or ac[0] is not mc[0]:
            continue
        add = ac[0]

        # single-consumer discipline on every interior value (the
        # probabilities fan out to the two slices)
        interior = [sp_nd, ss_nd, ktc_nd, kts_nd, concat, sm,
                    past_sl, self_sl, mm2, mulc] + chain_nodes
        if any(len(consumers(out)) != 1 for nd in interior if nd is not sm
               for out in nd.outputs):
            continue

        attrs = {"epilogue": tuple(epilogue), "cache_len": int(cache_len)}
        if qp_map is not None:
            if model.container == torch.int64:
                settle(sm, "an int64 container (a width above 8 bits): "
                       "the fused op fake-quantizes at 8 bits")
                continue
            attrs["bit_width"] = int(model.bit_width)
        qps = {key: qp_attr(value) for key, value in (
            ("q_qp", qh), ("ktc_qp", ktc_nd.outputs[0]),
            ("kts_qp", kts_nd.outputs[0]), ("p_qp", past_sl.outputs[0]),
            ("vc_qp", v_cache))}
        odd = [key for key, val in qps.items() if val is _PER_CHANNEL]
        if odd:
            settle(sm, f"non-scalar qparams on {', '.join(odd)}: the fused "
                   "op would drop their quantize step")
            continue
        attrs.update({key: val for key, val in qps.items()
                      if val is not None})
        fnode = Node(f"{add.name}/decode_attention", "DecodeAttention",
                     attrs, [qh, k_cache, kh, v_cache, vh] + extra_inputs,
                     [add.outputs[0]])
        model.nodes[model.nodes.index(add)] = fnode
        for nd in interior:
            if nd in model.nodes:
                model.nodes.remove(nd)
        producer[fnode.outputs[0].name] = fnode
        settle(sm)
        fused += 1
    return fused
