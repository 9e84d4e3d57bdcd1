"""Dead-token elimination pass: hoist a scalar token-axis Gather
backward through per-token ops so everything between the last
token-mixing op and the Gather computes ONLY the consumed token (the
ViT CLS-token classifier tail, reference models/vit.py:40-66)."""
from __future__ import annotations

from ..graph import Constant, Node, Variable
from .toolkit import consumers as _consumers, drops_graphs


@drops_graphs
def narrow_gather(model) -> int:
    """Dead-token elimination: hoist a scalar token-axis Gather (e.g.
    the ViT CLS-token pick before the classifier head, reference
    models/vit.py:40-66 exports `hidden[:, 0]` this way) backward
    through per-token ops, so everything between the last token-mixing
    op and the Gather computes ONLY the consumed token.

    On ViT-Base this narrows the last encoder layer's MLP
    (fc1 -> GELU -> fc2), its attention out-projection, both of its
    LayerNorms' tails and the final LayerNorm from 197 tokens to 1.
    The surviving row sees the same op sequence on the same values
    (integer matmuls are exact; float LN/erf are per token with the
    same within-row reduce order), so outputs are unchanged.

    An op hoists when slicing its inputs at the gathered token is
    value-identical to slicing its output:

    * per-token unary: LayerNormalization(axis=-1), FusedGelu, Erf,
      Identity, Tanh, Sigmoid, Relu, Neg, Sqrt;
    * ``MatMul x @ W`` with a rank-2 constant rhs (output rows are per
      input token);
    * binary Add/Sub/Mul/Div whose every operand either matches the
      full token shape (it gets its own hoisted Gather) or has
      rank <= 1 (broadcasts below the token axis);
    * ``FusedAttentionHS`` via its q input only (each output row
      depends on its own q row and all of K/V): the kernel then
      computes ONE query row (narrow-q path, kernels/attention.py)
      and the hoist continues up the q-projection chain.

    The hoist stops at multi-consumer values (anything still consumed
    full-width, e.g. the residual trunk the next layer's LayerNorm
    reads), graph outputs, and token-mixing ops (Softmax, Concat).
    Requires static shapes (``_infer_shapes``); returns the number of
    hoist steps."""
    shapes = model._infer_shapes()
    if shapes is None:
        return 0
    out_names = {o.name for o in model.outputs}

    UNARY = {"LayerNormalization", "FusedGelu", "Erf", "Identity",
             "Tanh", "Sigmoid", "Relu", "Neg", "Sqrt"}
    BINARY = {"Add", "Sub", "Mul", "Div"}

    def consumers(value):
        return _consumers(model, value)

    def producer_of(value):
        # live scan by identity: the pass inserts nodes while hoisting,
        # so a static name map would go stale
        for n in model.nodes:
            if value in n.outputs:
                return n
        return None

    moved = 0
    progress = True
    while progress:
        progress = False
        for gnode in [n for n in model.nodes if n.op == "Gather"]:
            if int(gnode.attrs.get("axis", 0)) != 1 \
                    or len(gnode.inputs) < 2:
                continue
            idx_val = gnode.inputs[1]
            if shapes.get(idx_val.name, None) != ():
                continue  # non-scalar index: axis survives
            v = gnode.inputs[0]
            if not isinstance(v, Variable) or v.name in out_names \
                    or len(shapes.get(v.name, ())) != 3:
                continue
            if consumers(v) != [gnode]:
                continue  # still consumed full-width elsewhere
            p = producer_of(v)
            if p is None or len(p.outputs) != 1:
                continue
            if p.op in UNARY:
                if p.op == "LayerNormalization":
                    if int(p.attrs.get("axis", -1)) not in (-1, 2):
                        continue
                    p.attrs["axis"] = -1  # rank drops below
                slice_idx = [0]
            elif p.op == "MatMul":
                w = p.inputs[1]
                if not isinstance(w, Constant) \
                        or len(shapes.get(w.name, ())) != 2:
                    continue
                slice_idx = [0]
            elif p.op == "FusedAttentionHS":
                # each attention output row depends on its own q row
                # and ALL of K/V, so gathering the output token is
                # gathering the q input token: the kernel runs with one
                # query row against full K/V (narrow-q path,
                # kernels/attention.py) -- on ViT this narrows the LAST
                # layer's score/context work and its whole q-projection
                # chain from 197 rows to 1
                if "causal_mask_val" in p.attrs or len(p.inputs) > 3:
                    # causal masking / the per-head score bias (4th
                    # input) index q rows by absolute position; a
                    # gathered q row would be masked/biased as row 0
                    continue
                slice_idx = [0]
            elif p.op in BINARY:
                vshape = shapes[v.name]
                slice_idx, ok = [], True
                for i, iv in enumerate(p.inputs):
                    ish = shapes.get(iv.name)
                    if ish == vshape:
                        slice_idx.append(i)
                    elif ish is not None and len(ish) <= 1:
                        pass  # broadcasts below the token axis
                    else:
                        ok = False
                        break
                if not ok or not slice_idx:
                    continue
            else:
                continue  # token-mixing or unknown: stop here

            out_val = gnode.outputs[0]
            p_pos = model.nodes.index(p)
            # the index's producer (a no-input Constant node) must run
            # before the hoisted Gathers it feeds
            idx_prod = producer_of(idx_val)
            if idx_prod is not None \
                    and model.nodes.index(idx_prod) > p_pos:
                if idx_prod.inputs:
                    continue  # non-constant index source: don't move
                model.nodes.remove(idx_prod)
                model.nodes.insert(p_pos, idx_prod)
                p_pos += 1
            new_inputs = list(p.inputs)
            for i in slice_idx:
                iv = p.inputs[i]
                # reuse an identical Gather on iv (two hoist fronts
                # meeting on the residual trunk)
                reuse = None
                for n in model.nodes:
                    if n is not gnode and n.op == "Gather" \
                            and len(n.inputs) > 1 \
                            and n.inputs[0] is iv \
                            and n.inputs[1] is idx_val \
                            and int(n.attrs.get("axis", 0)) == 1:
                        reuse = n
                        break
                if reuse is not None:
                    rpos = model.nodes.index(reuse)
                    if rpos > p_pos:  # keep topological order
                        model.nodes.remove(reuse)
                        model.nodes.insert(p_pos, reuse)
                        p_pos += 1
                    new_inputs[i] = reuse.outputs[0]
                    if p not in reuse.outputs[0].outputs:
                        reuse.outputs[0].outputs.append(p)
                    continue
                gv = Variable(f"{iv.name}/narrowed", inputs=[],
                              outputs=[p])
                gn = Node(f"{p.name}/narrow_gather_{i}", "Gather",
                          {"axis": 1}, [iv, idx_val], [gv])
                gv.inputs = [gn]
                iv.outputs = list(iv.outputs) + [gn]
                model.values.append(gv)
                qp = model.quant_params.get(iv.name)
                if qp is not None:
                    model.quant_params[gv.name] = qp
                ish = shapes[iv.name]
                shapes[gv.name] = (ish[0],) + ish[2:]
                model.nodes.insert(p_pos, gn)
                p_pos += 1
                new_inputs[i] = gv
            p.inputs = new_inputs
            p.outputs = [out_val]
            out_val.inputs = [p]
            model.nodes.remove(gnode)
            if v in model.values:
                model.values.remove(v)
            model.quant_params.pop(v.name, None)
            moved += 1
            progress = True
            break
    return moved
