"""Attention fusion pass: MatMul -> scale -> [mask/bias] -> Softmax ->
MatMul chains become one fused node backed by the hand-written CUDA
kernels (kernels/attention.py): FusedAttentionHS when the standard
multi-head split/merge surrounds the chain (the kernel splits and merges
heads itself), else FusedAttention on the pre-split [BH, N, D] heads (the
head shuffles stay in the graph, e.g. when RoPE and repeat_kv sit between
the split and the scores). Port of ``numpy_quant_tpu/passes/attention.py``:
no mask; the decoder's additive causal mask (full or sliding-window band);
or a general score-bias constant (T5 relative bias, its decoder's combined
bias + causal constant, ALiBi), which rides into FusedAttentionHS as a 4th
input. Each is added in the kernel at the graph Add's position. A bias on a
chain whose head split does not match stays unfused and is recorded as a
fusion failure.
"""
from __future__ import annotations

import numpy as np

from ..graph import Constant, Node
from ..tensor import FTensor, QTensor
from .toolkit import (
    consumers as _consumers,
    dequant_const_array,
    drops_graphs,
    host_array,
    perm_is,
    producer_map,
    scalar_const,
)


@drops_graphs
def fuse_attention(model) -> int:
    """Fuse attention chains into FusedAttentionHS nodes (the kernel
    consumes the raw [B, N, H*D] projection outputs and splits/merges
    heads itself, so none of the head shuffles touch device memory) or,
    where the head-split pattern does not match, FusedAttention nodes
    (recorded in ``model.fusion_report["plain_fusions"]``). Returns the
    number of fused blocks. Every Softmax that does NOT fuse is recorded
    with the reason in ``model.fusion_report["failures"]``.
    """
    model.fusion_report = {"fused": 0, "failures": []}
    if model.bit_width > 8:
        for n in model.nodes:
            if n.op == "Softmax":
                model.fusion_report["failures"].append(
                    (n.name, f"bit_width {model.bit_width} > 8: the "
                     "int8 attention kernels do not apply"))
        return 0
    producer = producer_map(model)

    def consumers(value):
        return _consumers(model, value)

    fused = 0

    def fail(sm, reason):
        model.fusion_report["failures"].append((sm.name, reason))

    for sm in [n for n in model.nodes if n.op == "Softmax"]:
        if int(sm.attrs.get("axis", -1)) != -1:
            fail(sm, f"softmax axis {sm.attrs.get('axis')} != -1")
            continue
        # optional additive causal mask (decoder graphs): the Softmax
        # input may be Add(scaled scores, triangular const); the kernel
        # adds the same value itself. A constant the causal matcher does
        # not claim matches as a general per-head score bias (T5 relative
        # position bias, its decoder's bias + causal constant, ALiBi),
        # fused as a kernel operand.
        mask_node, mask_val = _match_causal_mask(producer, sm.inputs[0])
        bias_node, bias_const = (None, None) if mask_node is not None \
            else _match_score_bias(producer, sm.inputs[0])
        add_node = mask_node if mask_node is not None else bias_node
        scale_val = sm.inputs[0] if add_node is None else \
            add_node.inputs[1 if isinstance(add_node.inputs[0], Constant)
                            else 0]
        mul = producer.get(scale_val.name)
        if mul is not None and mul.op == "MatMul":
            # exporter pre-scaled q (or k): scores feed softmax
            # directly; the kernel's scaling factor is 1
            mm1, mul, scaling = mul, None, 1.0
        elif mul is None or mul.op not in ("Mul", "Div"):
            fail(sm, "input is not a Mul/Div scale node or MatMul "
                 f"(got {mul.op if mul else 'graph input'})")
            continue
        else:
            mm1 = producer.get(mul.inputs[0].name)
            if mm1 is None or mm1.op != "MatMul":
                fail(sm, "scale node's input is not a MatMul "
                     f"(got {mm1.op if mm1 else 'graph input'})")
                continue
            # scale factor: a Constant NODE's attrs or an initializer
            # Constant -- dequantized if the PTQ pass quantized it,
            # exactly what the executor would use
            scaling = scalar_const(producer, mul.inputs[1])
            if scaling is None:
                fail(sm, "scale factor is not a scalar constant")
                continue
            if mul.op == "Div":
                scaling = 1.0 / scaling
        cons = consumers(sm.outputs[0])
        if len(cons) != 1 or cons[0].op != "MatMul" \
                or cons[0].inputs[0] is not sm.outputs[0]:
            fail(sm, "softmax output does not feed exactly one "
                 "MatMul as its lhs")
            continue
        mm2 = cons[0]
        chain_vals = [mm1.outputs[0]]
        if mul is not None:
            chain_vals.append(mul.outputs[0])
        if add_node is not None:
            chain_vals.append(add_node.outputs[0])
        if any(len(consumers(v)) != 1 for v in chain_vals):
            fail(sm, "scores/probabilities have consumers outside "
                 "the attention chain")
            continue
        probs_qp = model.quant_params[sm.outputs[0].name]
        attrs = {"scaling": scaling,
                 "probs_scale": float(np.float32(probs_qp.scale)),
                 "probs_zero_point": 0 if probs_qp.zero_point is None
                 else int(probs_qp.zero_point)}
        if mask_node is not None:
            attrs["causal_mask_val"] = mask_val[0]
            if mask_val[1] is not None:
                # banded (sliding-window) causal mask
                attrs["causal_window"] = mask_val[1]
        # calibrated max of the softmax INPUT: the fast serving kernel
        # uses it as a STATIC exp2 shift instead of the per-row max pass
        # (softmax is shift-invariant; a clamp keeps scores beyond the
        # calibrated range finite). For causal graphs it is the max of
        # the PRE-mask scores: the masked value's range is dominated by
        # the large negative mask entries.
        sm_in_qp = model.quant_params.get(scale_val.name)
        if sm_in_qp is not None and sm_in_qp.zero_point is not None \
                and getattr(sm_in_qp.scale, "ndim", 0) == 0:
            qmax = 2.0 ** (model.bit_width - 1) - 1
            attrs["score_max"] = float(
                (qmax - int(sm_in_qp.zero_point))
                * np.float32(sm_in_qp.scale))

        hs = _match_attention_hs(model, mm1, mm2, producer)
        if hs is not None:
            xq, xk, xv, out_value, num_heads, dead = hs
            f_inputs = [xq, xk, xv]
            if bias_node is not None:
                bshape = tuple(bias_const.data.data.shape)
                if len(bshape) >= 3 \
                        and bshape[-3] not in (1, num_heads):
                    fail(sm, f"score-bias constant head dim "
                         f"{bshape[-3]} is not 1 or num_heads "
                         f"{num_heads}")
                    continue
                # the bias constant rides as a 4th input: the executor
                # dequantizes it exactly as the unfused Add would, then the
                # kernel adds it per head (kernels/attention.py score_bias)
                f_inputs.append(bias_const)
            fnode = Node(f"{mm2.name}/fused_attention_hs",
                         "FusedAttentionHS", dict(attrs, num_heads=num_heads),
                         f_inputs, [out_value])
        elif bias_node is not None:
            # the plain kernel's [BH, N, D] layout has no head index to
            # slice a per-head bias by: only the shape-checked head-split
            # pattern fuses biased attention
            fail(sm, "score-bias constant present but the head-split"
                 " pattern did not match (bias fuses via"
                 " FusedAttentionHS only)")
            continue
        elif mul is None:
            # pre-scaled scores carry no standalone scale node to anchor a
            # safe plain fusion (the bare MatMul operands may be 2-D or
            # batch-broadcast, which the [BH, N, D] layout cannot express)
            fail(sm, "pre-scaled scores (no Mul/Div before Softmax):"
                 " only the head-split pattern fuses this form, and"
                 " it did not match")
            continue
        else:
            # plain fusion: the core on the pre-split [BH, N, D] heads; the
            # head Reshape/Transpose shuffles stay in the graph. Causal
            # graphs whose head-split chains carry extra structure (RoPE,
            # repeat_kv: models/llama.py) take this path.
            model.fusion_report.setdefault("plain_fusions", []).append(
                (sm.name, "head-split pattern not matched; fused the "
                 "core only (head shuffles remain in the graph)"))
            fnode = Node(f"{mm2.name}/fused_attention", "FusedAttention",
                         attrs, [mm1.inputs[0], mm1.inputs[1], mm2.inputs[1]],
                         [mm2.outputs[0]])
            dead = []
        idx = model.nodes.index(mm2)
        model.nodes[idx] = fnode
        for dn in dead:
            if dn in model.nodes:
                model.nodes.remove(dn)
        for dn in (mm1, mul, add_node, sm):
            if dn is not None:
                model.nodes.remove(dn)
        fused += 1
    if fused:
        model.quantized_ops = tuple(model.quantized_ops) \
            + ("FusedAttention", "FusedAttentionHS")
    model.fusion_report["fused"] = fused
    return fused


def _match_causal_mask(producer, value):
    """Match ``Add(x, C)`` feeding a Softmax where C dequantizes to a
    causal additive mask: 0 on a (possibly BANDED) region at or below
    the diagonal, ONE large negative value everywhere else -- the
    decoder-exporter idiom (models/gpt.py), including Mistral-style
    sliding windows. Returns (add_node, (mask_value, window)) --
    mask_value is the EXECUTOR-exact dequantized constant and window the
    band width (None = full causal), so the fused kernel's add is
    bit-identical to the unfused graph's -- or (None, None)."""
    node = producer.get(value.name)
    if node is None or node.op != "Add":
        return None, None
    consts = [v for v in node.inputs if isinstance(v, Constant)]
    if len(consts) != 1 or consts[0].data is None:
        return None, None
    arr = dequant_const_array(consts[0])
    if arr is None:
        return None, None
    if arr.ndim < 2 or arr.shape[-1] != arr.shape[-2] \
            or any(s != 1 for s in arr.shape[:-2]):
        return None, None
    m = arr.reshape(arr.shape[-2], arr.shape[-1])
    n = m.shape[0]
    # band width from the last row's visible run (full causal = n)
    window = int((m[n - 1] == 0).sum())
    if window == 0:
        return None, None
    i, j = np.indices(m.shape)
    visible = (j <= i) & (j > i - window)
    if not (m[visible] == 0).all():
        return None, None
    masked = m[~visible]
    if masked.size == 0:
        return None, None  # window == n == 1: nothing to fuse on
    if not (masked == masked[0]).all() or not masked[0] < -1e4:
        return None, None
    return node, (float(masked[0]), None if window >= n else window)


def _match_score_bias(producer, value):
    """Match ``Add(x, C)`` feeding a Softmax where C is a general additive
    score-bias constant the causal matcher did not claim: T5 relative
    position bias, ALiBi slopes, document masks, or the T5 decoder's
    combined bias + causal constant. C is a float or quantized constant of
    rank >= 2 whose dims before the last three are 1 (it broadcasts over
    the batch); its last three dims broadcast to the scores' [H, Nq, Nk].
    Returns (add_node, bias constant value) or (None, None): the value,
    not a folded array, so that execution dequantizes it exactly as the
    unfused Add would."""
    node = producer.get(value.name)
    if node is None or node.op != "Add":
        return None, None
    consts = [v for v in node.inputs if isinstance(v, Constant)]
    if len(consts) != 1 or consts[0].data is None:
        return None, None
    d = consts[0].data
    if not isinstance(d, (QTensor, FTensor)):
        return None, None
    shape = tuple(d.data.shape)
    if len(shape) < 2 or any(s != 1 for s in shape[:-3]):
        return None, None
    return node, consts[0]


def _match_attention_hs(model, mm1, mm2, producer):
    """Match the standard multi-head split/merge around a fused
    attention core:

        x{q,k,v} -> Reshape[B,N,H,D] -> Transpose(0,2,1,3)   (q, v)
        xk       -> Reshape -> Transpose(0,2,1,3) -> Transpose(0,1,3,2)
                    (or the composed single Transpose(0,2,3,1) some
                    exporters emit for the key side)
        mm2 out  -> Transpose(0,2,1,3) -> Reshape[B,N,H*D]

    The head-split Reshape's target shape may be the torch exporter's
    Concat(batch_dim, [-1, H, D] constant) or a plain 4-dim shape
    constant (node or initializer).

    Returns (xq, xk, xv, merged_out_value, num_heads, dead_nodes)
    or None."""

    def consumers(value):
        return _consumers(model, value)

    def heads_from_reshape(node):
        """Head count from a head-split Reshape's target shape."""
        shp = node.inputs[1]
        shape_src = producer.get(shp.name)
        if shape_src is not None and shape_src.op == "Concat":
            # Concat(batch_dim, Constant[-1 (or N), H, D])
            tail = producer.get(shape_src.inputs[-1].name)
            if tail is None or tail.op != "Constant":
                return None
            tail_arr = np.asarray(tail.attrs["value"]).reshape(-1)
            return int(tail_arr[1]) if tail_arr.size == 3 else None
        # plain 4-dim shape constant: [B|-1, N|-1, H, D]
        if shape_src is not None and shape_src.op == "Constant":
            arr = np.asarray(shape_src.attrs["value"]).reshape(-1)
        elif isinstance(shp, Constant) and shp.data is not None:
            arr = host_array(shp.data.data).reshape(-1)
        else:
            return None
        return int(arr[2]) if arr.size == 4 and int(arr[2]) > 0 \
            else None

    def back(value, perm_alts):
        """value <- Transpose chain (one of ``perm_alts``) <-
        Reshape <- src"""
        for perms in perm_alts:
            dead = []
            v = value
            ok = True
            for perm in perms:
                node = producer.get(v.name)
                if node is None or node.op != "Transpose" \
                        or not perm_is(node, perm) \
                        or len(consumers(node.outputs[0])) != 1:
                    ok = False
                    break
                dead.append(node)
                v = node.inputs[0]
            if not ok:
                continue
            node = producer.get(v.name)
            if node is None or node.op != "Reshape" \
                    or len(consumers(node.outputs[0])) != 1:
                continue
            num_heads = heads_from_reshape(node)
            if num_heads is None:
                continue
            dead.append(node)
            return node.inputs[0], num_heads, dead
        return None

    rq = back(mm1.inputs[0], [[(0, 2, 1, 3)]])
    # key side: the two-step transpose, or its composition
    rk = back(mm1.inputs[1], [[(0, 1, 3, 2), (0, 2, 1, 3)],
                              [(0, 2, 3, 1)]])
    rv = back(mm2.inputs[1], [[(0, 2, 1, 3)]])
    if rq is None or rk is None or rv is None:
        return None
    if not (rq[1] == rk[1] == rv[1]):
        return None
    # forward: mm2 -> Transpose(0,2,1,3) -> Reshape -> merged
    cons = consumers(mm2.outputs[0])
    if len(cons) != 1 or cons[0].op != "Transpose" \
            or not perm_is(cons[0], (0, 2, 1, 3)):
        return None
    tr_out = cons[0]
    cons2 = consumers(tr_out.outputs[0])
    if len(cons2) != 1 or cons2[0].op != "Reshape":
        return None
    rs_out = cons2[0]
    dead = rq[2] + rk[2] + rv[2] + [tr_out, rs_out]
    return (rq[0], rk[0], rv[0], rs_out.outputs[0], rq[1], dead)
