"""The sharded walk: what XLA's GSPMD does for the JAX package, done op by
op on each rank.

Every value of a forward carries a layout, ``{axis: (mesh axis, outer)}``:
the axis is split over the mesh axis's ranks, each rank holding a
contiguous piece of each of ``outer`` equal blocks (``outer`` is 1 for a
plainly split axis; it grows where a Reshape merges a sharded axis into a
leading one, e.g. [B, H/tp, N, D] -> [B*H/tp, N, D]). Inputs split their
batch over the data axis, parameters arrive as this rank's shards
(:mod:`.sharding`), and each op either runs on the local pieces and
propagates the layout, or first gathers the axes it needs whole:

* elementwise ops, GELU, quantize/dequantize and bias adds act per shard
  (a replicated operand is sliced to the shard);
* a MatMul against a column-sharded weight runs at N/tp; against a
  row-sharded weight it runs at K/tp and all-reduces its int32
  accumulator (exact) before the zero-point correction with the global
  column sums, or its float partial sums (a float product: ulps);
* Reshape moves the sharded axis (a hidden axis split into (H, D) gives
  H/tp in the local shape), Transpose permutes it;
* the attention ops run on the local heads (``num_heads // tp``, the
  score bias sliced along its head axis);
* LayerNorm, Softmax and reductions over a sharded axis, Split/Slice/
  Concat/Gather along one, and every op without a rule gather first;
* the graph outputs are gathered whole, so every rank returns the global
  result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.registry import onnx_operator_implementation, score_bias_operand
from ..quantization import int_matmul, wide_matmul
from ..intops import as_tensor
from ..tensor import DITensor, FTensor, ITensor, PackedQTensor, QTensor
from . import mesh as M

ELEMENTWISE = set("""Add Sub Mul Div Pow Max Min Sum Mean Equal Greater
GreaterOrEqual Less LessOrEqual And Or Xor Not Where Mod BitShift BitwiseAnd
BitwiseOr BitwiseXor BitwiseNot PRelu Abs Acos Acosh Asin Asinh Atan Atanh
Ceil Cos Cosh Erf Exp Floor Log Neg Reciprocal Relu Round Sigmoid Sign Sin
Sinh Sqrt Tan Tanh Softplus Softsign Selu Elu Celu LeakyRelu HardSigmoid
HardSwish Mish Gelu FusedGelu ThresholdedRelu Shrink IsInf IsNaN Identity
Cast Clip""".split())
# ops independent along the batch axis 0 (N of NCHW)
BATCHED = set("""Conv ConvTranspose MaxPool AveragePool GlobalAveragePool
GlobalMaxPool BatchNormalization InstanceNormalization GroupNormalization
LpPool""".split())


def _ndim(t) -> int:
    """Logical rank (a packed weight's is 2, whatever its payload's)."""
    return len(t.shape) if isinstance(t, (QTensor, PackedQTensor)) \
        else int(t.data.ndim)


def _lshape(t) -> tuple:
    return tuple(int(d) for d in t.data.shape)


def _piece(d: torch.Tensor, axis: int, outer: int, parts: int,
           index: int) -> torch.Tensor:
    """The ``index``-th piece of each of ``outer`` blocks along ``axis``."""
    shape = d.shape
    g = shape[axis]
    v = d.reshape(shape[:axis] + (outer, g // outer) + shape[axis + 1:])
    w = g // outer // parts
    v = v.narrow(axis + 1, index * w, w)
    return v.reshape(shape[:axis] + (g // parts,) + shape[axis + 1:]) \
        .contiguous()


class ShardedWalk:
    def __init__(self, model):
        self.model = model
        self.mesh = model.mesh
        self.layout: dict[str, dict] = {}

    # ------------------------------------------------------------------
    # moving one axis
    # ------------------------------------------------------------------

    def _apply(self, t, axis: int, fn):
        """``fn(tensor, axis)`` on ``t``'s data and on whatever of its
        zero point and scale varies along ``axis``."""
        nd = _ndim(t)
        if isinstance(t, FTensor):
            return FTensor(fn(t.data, axis))
        if isinstance(t, DITensor):
            return DITensor(fn(t.data, axis))
        if isinstance(t, QTensor):
            zp, scale = t.zero_point, t.scale
            if isinstance(zp, torch.Tensor) and zp.ndim:
                za = zp.ndim - (nd - axis)
                if za >= 0 and zp.shape[za] > 1:
                    zp = fn(zp, za)
            if getattr(scale, "ndim", 0):
                s = np.asarray(scale)
                sa = s.ndim - (nd - axis)
                if sa >= 0 and s.shape[sa] > 1:
                    st = torch.from_numpy(np.ascontiguousarray(s)).to(
                        t.data.device)
                    scale = fn(st, sa).cpu().numpy()
            return QTensor(fn(t.data, axis), t.bit_width, scale, zp)
        raise ValueError(f"cannot move a {type(t).__name__} across ranks")

    def slice_axis(self, t, axis: int, spec):
        m, outer = spec
        p, r = self.mesh.shape[m], self.mesh.index(m)
        return self._apply(t, axis,
                           lambda d, a: _piece(d, a, outer, p, r))

    def gather_axis(self, t, axis: int, spec):
        m, outer = spec
        p = self.mesh.shape[m]

        def fn(d, a):
            shape = d.shape
            v = d.reshape(shape[:a] + (outer, shape[a] // outer)
                          + shape[a + 1:])
            v = M.all_gather(v, self.mesh, m, dim=a + 1)
            return v.reshape(shape[:a] + (shape[a] * p,) + shape[a + 1:])

        return self._apply(t, axis, fn)

    def gather(self, t, lay: dict, axes=None):
        """(t, layout) with ``axes`` (default: all) gathered whole."""
        lay = dict(lay)
        for a in sorted(lay if axes is None else axes):
            if a in lay:
                t = self.gather_axis(t, a, lay.pop(a))
        return t, lay

    def global_shape(self, t, lay: dict) -> tuple:
        shape = list(_lshape(t))
        for a, (m, _) in lay.items():
            shape[a] *= self.mesh.shape[m]
        return tuple(shape)

    # ------------------------------------------------------------------
    # the walk's entry and exit
    # ------------------------------------------------------------------

    def constant(self, value, tensor):
        """This rank's piece of a constant, its layout recorded (a stacked
        payload's row group is a whole packed weight of its own)."""
        spec = self.model._local_specs().get(value.name)
        if spec is None or spec[0] == "stacked":
            return tensor
        if spec[0] == "column":
            self.layout[value.name] = {1: (spec[1], 1)}
        else:
            self.layout[value.name] = {
                a: (m, 1) for a, m in enumerate(spec) if m is not None}
        return tensor

    def input(self, name: str, t):
        """A global input: its batch split over the data axis when it
        divides (else every rank runs every row)."""
        local = self.model._local_io.get(name)
        if local is not None:
            # already this rank's piece (a KV cache kept per rank)
            self.layout[name] = dict(local)
            return t
        ax = self.model.data_axis
        if ax is None or isinstance(t, ITensor) or t is None \
                or isinstance(t, PackedQTensor):
            return t
        p = self.mesh.shape[ax]
        if p == 1 or _ndim(t) == 0 or _lshape(t)[0] % p:
            return t
        spec = (ax, 1)
        self.layout[name] = {0: spec}
        return self.slice_axis(t, 0, spec)

    def output(self, name: str, t):
        lay = self.layout.get(name)
        want = self.model._local_io.get(name)
        if want is not None and t is not None:
            # handed back as this rank's piece in the declared layout
            lay = dict(lay or {})
            t, lay = self.gather(t, lay, [a for a, s in lay.items()
                                          if want.get(a) != s])
            for a, spec in want.items():
                if a not in lay:
                    t = self.slice_axis(t, a, spec)
            self.layout[name] = dict(want)
            return t
        if not lay or t is None:
            return t
        t, _ = self.gather(t, lay)
        self.layout[name] = {}
        return t

    def lay(self, value) -> dict:
        return dict(self.layout.get(value.name, {})) if value is not None \
            else {}

    # ------------------------------------------------------------------
    # one node
    # ------------------------------------------------------------------

    def run(self, node, ins: list) -> list:
        lays = [self.lay(v) for v in node.inputs]
        op = node.op
        if not any(lays):
            outs = self._plain(node, ins)
            for o in node.outputs:
                self.layout[o.name] = {}
            return outs
        rule = _RULES.get(op)
        if rule is None:
            if op in ELEMENTWISE:
                rule = ShardedWalk._elementwise
            elif op in BATCHED:
                rule = ShardedWalk._batched
        if rule is not None:
            res = rule(self, node, ins, lays)
            if res is not None:
                outs, out_lays = res
                for o, lo in zip(node.outputs, out_lays):
                    self.layout[o.name] = lo
                return outs
        return self._fallback(node, ins, lays)

    def _plain(self, node, ins, attrs=None):
        if node.op in ("If", "Loop"):
            raise NotImplementedError(
                f"{node.op} under a mesh: a body reads enclosing values "
                "whole; run the model unsharded")
        return onnx_operator_implementation(node.op, ins,
                                            node.attrs if attrs is None
                                            else attrs)

    def _fallback(self, node, ins, lays):
        full = []
        for t, lay in zip(ins, lays):
            if lay:
                t, _ = self.gather(t, lay)
            full.append(t)
        outs = self._plain(node, full)
        for o in node.outputs:
            self.layout[o.name] = {}
        return outs

    # ------------------------------------------------------------------
    # alignment of broadcast operands
    # ------------------------------------------------------------------

    def _align(self, ins, lays, nd_out=None, skip=()):
        """Bring broadcast operands to one output layout: conflicting
        shardings gather, replicated operands slice to the shard. Returns
        (operands, output layout) or None when a host operand would need
        slicing. ``skip``: output axes left out (gathered)."""
        present = [(i, t) for i, t in enumerate(ins) if t is not None]
        if nd_out is None:
            nd_out = max(_ndim(t) for _, t in present)
        ins, lays = list(ins), [dict(x) for x in lays]
        target: dict = {}
        used: dict = {}
        for i, t in present:
            off = nd_out - _ndim(t)
            for a, spec in sorted(lays[i].items()):
                oa = a + off
                if oa in skip or (oa in target and target[oa] != spec) \
                        or (oa not in target and spec[0] in used):
                    ins[i], lays[i] = self.gather(ins[i], lays[i], [a])
                    continue
                target[oa] = spec
                used[spec[0]] = oa
        for i, t in present:
            off = nd_out - _ndim(ins[i])
            for oa, spec in target.items():
                a = oa - off
                if a < 0 or a in lays[i] or _lshape(ins[i])[a] == 1:
                    continue
                if isinstance(ins[i], ITensor):
                    return None
                ins[i] = self.slice_axis(ins[i], a, spec)
                lays[i][a] = spec
        return ins, target

    def _elementwise(self, node, ins, lays):
        res = self._align(ins, lays)
        if res is None:
            return None
        ins, target = res
        outs = self._plain(node, ins)
        return outs, [dict(target) for _ in outs]

    def _batched(self, node, ins, lays):
        x, lay = self.gather(ins[0], lays[0],
                             [a for a in lays[0] if a != 0])
        rest = [self.gather(t, l)[0] if l else t
                for t, l in zip(ins[1:], lays[1:])]
        outs = self._plain(node, [x] + rest)
        return outs, [dict(lay)] + [{} for _ in outs[1:]]

    # ------------------------------------------------------------------
    # products
    # ------------------------------------------------------------------

    def _weight_split(self, value):
        """("column" | "row", mesh axis) of a sharded 2-D weight constant,
        else None."""
        spec = self.model._local_specs().get(value.name) \
            if value is not None else None
        if spec is None:
            return None
        if spec[0] == "stacked":
            return "row", spec[1]
        if spec[0] == "column" or spec[0] is None:
            return "column", spec[1]
        return "row", spec[0]

    def _matmul(self, node, ins, lays):
        a, b = ins[0], ins[1]
        la, lb = lays[0], lays[1]
        split = self._weight_split(node.inputs[1])
        na = _ndim(a)
        if split is None:
            if lb or (_ndim(b) > 2 and la):
                return self._batched_matmul(node, ins, lays)
            # a replicated rhs: the contraction axis whole
            a, la = self.gather(a, la, [na - 1])
            return self._plain(node, [a, b]), [la]
        kind, m = split
        if kind == "column":
            a, la = self.gather(a, la, [na - 1])
            lo = dict(la)
            lo[na - 1] = (m, 1)
            return self._plain(node, [a, b]), [lo]
        a, la = self._k_shard(a, la, na - 1, m)
        return [self._row_product(a, b, m)], [la]

    def _k_shard(self, a, la, axis, m):
        """``a`` split along its contraction axis over ``m``."""
        if la.get(axis) != (m, 1):
            a, la = self.gather(a, la, [axis])
            a = self.slice_axis(a, axis, (m, 1))
        la = dict(la)
        la.pop(axis, None)
        return a, la

    def _row_product(self, a, b, m):
        """A product against a K-sharded weight: the local partial product,
        all-reduced over ``m``; an integer product reduces its
        accumulator before the zero-point correction with the global
        column sums."""
        from ..ops.registry import _weight_only_matmul
        mesh = self.mesh
        if isinstance(b, PackedQTensor):
            b = b.unpack()
        if isinstance(a, QTensor) and isinstance(b, QTensor):
            wide = a.data.dtype == torch.int64 or b.data.dtype == torch.int64
            bw = max(a.bit_width, b.bit_width)
            acc = wide_matmul(a.data, b.data, bw) if wide \
                else int_matmul(a.data, b.data)
            acc = M.all_reduce(acc, mesh, m)
            scale = np.asarray(a.scale, np.float32) \
                * np.asarray(b.scale, np.float32)
            if scale.ndim == 0:
                scale = np.float32(scale)
            idt = torch.int64 if wide else torch.int32
            dev = acc.device
            zpa, zpb = a.zero_point, b.zero_point
            zp = None
            if zpa is not None or zpb is not None:
                colsum = b.colsum
                if colsum is None:
                    raise ValueError("a K-sharded product needs the "
                                     "weight's global column sums")
                k = a.data.shape[-1] * mesh.shape[m]
                if zpb is not None:
                    rowsum = M.all_reduce(a.data.to(idt).sum(
                        dim=-1, keepdim=True, dtype=idt), mesh, m)
                if zpa is None:
                    zp = rowsum * as_tensor(zpb, dev, idt)
                elif zpb is None:
                    zp = colsum.to(idt) * as_tensor(zpa, dev, idt)
                else:
                    za = as_tensor(zpa, dev, idt)
                    zb = as_tensor(zpb, dev, idt)
                    zp = rowsum * zb + colsum.to(idt) * za - za * zb * k
            return QTensor(acc, 4 * bw, scale, zp)
        if isinstance(a, FTensor) and isinstance(b, QTensor):
            y = _weight_only_matmul(a, b)
        else:
            if isinstance(a, QTensor):
                a = a.dequantize()
            if isinstance(b, QTensor):
                b = b.dequantize()
            y = a.matmul(b)
        return FTensor(M.all_reduce(y.data, mesh, m))

    def _batched_matmul(self, node, ins, lays):
        """activation x activation: the two trailing axes gathered, the
        leading (batch, head) axes aligned."""
        a, la = self.gather(ins[0], lays[0], [_ndim(ins[0]) - 2,
                                              _ndim(ins[0]) - 1])
        b, lb = self.gather(ins[1], lays[1], [_ndim(ins[1]) - 2,
                                              _ndim(ins[1]) - 1])
        res = self._align([a, b], [la, lb])
        if res is None:
            return None
        (a, b), target = res
        return self._plain(node, [a, b]), [target]

    def _matmul_split(self, node, ins, lays):
        a, la = self.gather(ins[0], lays[0], [_ndim(ins[0]) - 1])
        split = self._weight_split(node.inputs[1])
        attrs = node.attrs
        m = None
        if split is not None and split[0] == "column":
            m = split[1]
            p = self.mesh.shape[m]
            attrs = dict(attrs, segments=[int(s) // p
                                          for s in attrs["segments"]])
        outs = self._plain(node, [a, ins[1]], attrs)
        lo = dict(la)
        if m is not None:
            lo[_ndim(a) - 1] = (m, 1)
        return outs, [dict(lo) for _ in outs]

    def _gemm(self, node, ins, lays):
        if int(node.attrs.get("transA", 0)) or any(lays[1:]):
            return None
        c = ins[2] if len(ins) > 2 else None
        if c is not None and _ndim(c) == 2 and _lshape(c)[0] > 1:
            return None
        a, la = self.gather(ins[0], lays[0], [1])
        return self._plain(node, [a] + list(ins[1:])), [la]

    # ------------------------------------------------------------------
    # attention
    # ------------------------------------------------------------------

    def _heads(self, node, ins, lays):
        """FusedAttentionHS on [B, N, H*D] q/k/v: the local heads."""
        q, k, v = ins[:3]
        lq, lk, lv = lays[:3]
        last = [_ndim(q) - 1, _ndim(k) - 1, _ndim(v) - 1]
        specs = {lq.get(last[0]), lk.get(last[1]), lv.get(last[2])}
        heads = int(node.attrs["num_heads"])
        spec = specs.pop() if len(specs) == 1 else None
        if spec is not None and (spec[1] != 1
                                 or heads % self.mesh.shape[spec[0]]):
            spec = None
        ts, ls = [q, k, v], [lq, lk, lv]
        for i in range(3):
            keep = [0] if spec is None else [0, last[i]]
            ts[i], ls[i] = self.gather(ts[i], ls[i],
                                       [a for a in ls[i] if a not in keep])
        b0 = {ls[0].get(0), ls[1].get(0), ls[2].get(0)}
        if len(b0) > 1:
            for i in range(3):
                ts[i], ls[i] = self.gather(ts[i], ls[i], [0])
        attrs = node.attrs
        rest = list(ins[3:])
        if rest and rest[0] is not None:
            bias = rest[0]
            if lays[3]:
                bias, _ = self.gather(bias, lays[3])
            n = _lshape(ts[1])[1]
            nq = 1 if _ndim(ts[0]) == 2 else _lshape(ts[0])[1]
            bias = score_bias_operand(bias, heads, nq, n)
            if spec is not None:
                bias = _piece(bias, 0, 1, self.mesh.shape[spec[0]],
                              self.mesh.index(spec[0]))
            rest[0] = FTensor(bias)
        if spec is not None:
            # this rank's heads, summed where they lie among all the heads
            p = self.mesh.shape[spec[0]]
            attrs = dict(attrs, num_heads=heads // p, head_total=heads,
                         head_base=heads // p * self.mesh.index(spec[0]))
        outs = self._plain(node, ts + rest, attrs)
        return outs, [dict(ls[0])]

    def _lead(self, node, ins, lays):
        """FusedAttention / DecodeAttention: independent along every axis
        but the last two."""
        ts, ls = [], []
        for t, lay in zip(ins, lays):
            if t is None:
                ts.append(t)
                ls.append({})
                continue
            nd = _ndim(t)
            t, lay = self.gather(t, lay, [nd - 2, nd - 1])
            ts.append(t)
            ls.append(lay)
        nd_out = max(_ndim(t) for t in ts if t is not None)
        res = self._align(ts, ls, nd_out, skip=(nd_out - 2, nd_out - 1))
        if res is None:
            return None
        ts, target = res
        attrs = node.attrs
        if target and (node.op == "DecodeAttention"
                       or _ndim(ts[0]) == 4):
            # where this rank's (batch row, head) block lies in the whole
            # [B, H] grid: DecodeAttention's float dots run there, and
            # FusedAttention's softmax rows sum in that order
            # (ops/registry.py)
            g = self.global_shape(ts[0], {a: s for a, s in target.items()
                                          if a < 2})
            base = [0, 0]
            for a, (m, _) in target.items():
                if a < 2:
                    base[a] = g[a] // self.mesh.shape[m] * self.mesh.index(m)
            attrs = dict(attrs, lead_whole=tuple(g[:2]),
                         lead_base=tuple(base))
        return self._plain(node, ts, attrs), [target]

    # ------------------------------------------------------------------
    # reductions and normalizations
    # ------------------------------------------------------------------

    def _over(self, node, ins, lays, axes, keepdims=True):
        nd = _ndim(ins[0])
        axes = sorted({int(a) % nd for a in axes})
        x, lay = self.gather(ins[0], lays[0], axes)
        rest = [self.gather(t, l)[0] if l else t
                for t, l in zip(ins[1:], lays[1:])]
        outs = self._plain(node, [x] + rest)
        if not keepdims:
            lay = {a - sum(1 for r in axes if r < a): s
                   for a, s in lay.items()}
        return outs, [dict(lay) for _ in outs]

    def _layer_norm(self, node, ins, lays):
        nd = _ndim(ins[0])
        axis = int(node.attrs.get("axis", -1)) % nd
        return self._over(node, ins, lays, range(axis, nd))

    def _softmax(self, node, ins, lays):
        return self._over(node, ins, lays, [node.attrs.get("axis", -1)])

    def _reduce(self, node, ins, lays):
        nd = _ndim(ins[0])
        if len(ins) > 1 and ins[1] is not None:
            axes = [int(a) for a in np.asarray(ins[1].data).reshape(-1)]
        elif "axes" in node.attrs:
            axes = [int(a) for a in node.attrs["axes"]]
        elif "axis" in node.attrs:
            axes = [int(node.attrs["axis"])]
        else:
            axes = list(range(nd))
        keep = bool(int(node.attrs.get("keepdims", 1)))
        return self._over(node, ins, lays, axes or range(nd), keep)

    def _arg(self, node, ins, lays):
        keep = bool(int(node.attrs.get("keepdims", 1)))
        return self._over(node, ins, lays, [node.attrs.get("axis", 0)], keep)

    def _topk(self, node, ins, lays):
        return self._over(node, ins, lays, [node.attrs.get("axis", -1)])

    # ------------------------------------------------------------------
    # shape ops
    # ------------------------------------------------------------------

    def _shape(self, node, ins, lays):
        if "start" in node.attrs or "end" in node.attrs:
            return None
        g = self.global_shape(ins[0], lays[0])
        return [ITensor(np.array(g, dtype=np.int64))], [{}]

    def _reshape_to(self, x, lay, target):
        """(x, layout, local target) of a Reshape to the global
        ``target``; sharded axes that do not map cleanly gather first."""
        while True:
            g = self.global_shape(x, lay)
            tgt = list(target)
            if -1 in tgt:
                i = tgt.index(-1)
                known = int(np.prod([d for j, d in enumerate(tgt)
                                     if j != i]))
                tgt[i] = int(np.prod(g)) // max(known, 1)
            new, bad = {}, None
            for a, (m, outer) in sorted(lay.items()):
                p = self.mesh.shape[m]
                suffix = int(np.prod(g[a + 1:]))
                stride = g[a] // (outer * p) * suffix  # of the rank piece
                hit = None
                for j, t in enumerate(tgt):
                    suf_j = int(np.prod(tgt[j + 1:]))
                    if t % p == 0 and stride % suf_j == 0 \
                            and (suf_j * t) % (stride * p) == 0:
                        hit = (j, (m, suf_j * t // (stride * p)))
                        break
                if hit is None or hit[0] in new:
                    bad = a
                    break
                new[hit[0]] = hit[1]
            if bad is None:
                local = list(tgt)
                for j, (m, _) in new.items():
                    local[j] //= self.mesh.shape[m]
                return x, new, local
            x, lay = self.gather(x, lay, [bad])

    def _reshape(self, node, ins, lays):
        x, shape = ins[0], ins[1]
        g = self.global_shape(x, lays[0])
        target = [int(d) for d in np.asarray(shape.data).reshape(-1)]
        if not int(node.attrs.get("allowzero", 0)):
            target = [g[i] if d == 0 else d for i, d in enumerate(target)]
        x, lay, local = self._reshape_to(x, lays[0], target)
        out = self._plain(node, [x, ITensor(np.array(local, np.int64))],
                          {"allowzero": 1})
        return out, [lay]

    def _flatten(self, node, ins, lays):
        g = self.global_shape(ins[0], lays[0])
        axis = int(node.attrs.get("axis", 1)) % (len(g) + 1)
        target = [int(np.prod(g[:axis])), int(np.prod(g[axis:]))]
        x, lay, local = self._reshape_to(ins[0], lays[0], target)
        out = onnx_operator_implementation(
            "Reshape", [x, ITensor(np.array(local, np.int64))],
            {"allowzero": 1})
        return out, [lay]

    def _transpose(self, node, ins, lays):
        nd = _ndim(ins[0])
        perm = node.attrs.get("perm")
        perm = list(reversed(range(nd))) if perm is None \
            else [int(p) for p in perm]
        lay = {perm.index(a): s for a, s in lays[0].items()}
        return self._plain(node, ins), [lay]

    def _unsqueeze(self, node, ins, lays):
        axes = np.asarray(ins[1].data if len(ins) > 1 and ins[1] is not None
                          else node.attrs["axes"]).reshape(-1)
        nd = _ndim(ins[0]) + len(axes)
        axes = sorted(int(a) % nd for a in axes)
        kept = [a for a in range(nd) if a not in axes]
        lay = {kept[a]: s for a, s in lays[0].items()}
        return self._plain(node, ins), [lay]

    def _squeeze(self, node, ins, lays):
        nd = _ndim(ins[0])
        g = self.global_shape(ins[0], lays[0])
        if len(ins) > 1 and ins[1] is not None:
            axes = [int(a) % nd for a in np.asarray(ins[1].data).reshape(-1)]
        elif "axes" in node.attrs:
            axes = [int(a) % nd for a in node.attrs["axes"]]
        else:
            axes = [a for a in range(nd) if g[a] == 1]
        lay = {a - sum(1 for r in axes if r < a): s
               for a, s in lays[0].items()}
        out = self._plain(node, [ins[0], ITensor(np.array(axes, np.int64))],
                          {})
        return out, [lay]

    def _expand(self, node, ins, lays):
        x, shape = ins[0], ins[1]
        tgt = [int(d) for d in np.asarray(shape.data).reshape(-1)]
        nd = max(len(tgt), _ndim(x))
        tgt = [1] * (nd - len(tgt)) + tgt
        off = nd - _ndim(x)
        xs = _lshape(x)
        lay = {}
        for a, s in lays[0].items():
            tgt[a + off] = xs[a]
            lay[a + off] = s
        out = self._plain(node, [x, ITensor(np.array(tgt, np.int64))])
        return out, [lay]

    def _concat(self, node, ins, lays):
        nd = _ndim(ins[0])
        axis = int(node.attrs["axis"]) % nd
        res = self._align(ins, lays, nd, skip=(axis,))
        if res is None:
            return None
        ins, target = res
        return self._plain(node, ins), [target]

    def _split(self, node, ins, lays):
        x, lay = ins[0], lays[0]
        nd = _ndim(x)
        axis = int(node.attrs.get("axis", 0)) % nd
        spec = lay.get(axis)
        x, lay = self.gather(x, lay, [axis])
        outs = self._plain(node, [x] + list(ins[1:]))
        lo = []
        for i, t in enumerate(outs):
            ol = dict(lay)
            if spec is not None and spec[1] == 1 \
                    and _lshape(t)[axis] % self.mesh.shape[spec[0]] == 0:
                # reshard: a fused QKV projection splits back into heads
                # each rank holds a slice of
                outs[i] = self.slice_axis(t, axis, spec)
                ol[axis] = spec
            lo.append(ol)
        return outs, lo

    def _slice(self, node, ins, lays):
        x, lay = ins[0], lays[0]
        g = self.global_shape(x, lay)
        starts = np.asarray(ins[1].data).reshape(-1)
        ends = np.asarray(ins[2].data).reshape(-1)
        axes = np.asarray(ins[3].data).reshape(-1) \
            if len(ins) > 3 and ins[3] is not None \
            else np.arange(len(starts))
        steps = np.asarray(ins[4].data).reshape(-1) \
            if len(ins) > 4 and ins[4] is not None \
            else np.ones(len(starts), np.int64)
        nd = _ndim(x)
        need = []
        for s, e, a, st in zip(starts, ends, axes, steps):
            a = int(a) % nd
            if a not in lay:
                continue
            s = int(s) + g[a] if int(s) < 0 else int(s)
            if not (s == 0 and int(e) >= g[a] and int(st) == 1):
                need.append(a)
        x, lay = self.gather(x, lay, need)
        return self._plain(node, [x] + list(ins[1:])), [lay]

    def _gather_op(self, node, ins, lays):
        x, idx = ins[0], ins[1]
        nd = _ndim(x)
        axis = int(node.attrs.get("axis", 0)) % nd
        x, lx = self.gather(x, lays[0], [axis])
        li = lays[1]
        if li and isinstance(x, ITensor):
            idx, li = self.gather(idx, li)
        ni = 0 if isinstance(idx, ITensor) and np.ndim(idx.data) == 0 \
            else _ndim(idx)
        lay = {}
        for a, s in lx.items():
            lay[a if a < axis else a + ni - 1] = s
        for a, s in li.items():
            lay[axis + a] = s
        return self._plain(node, [x, idx]), [lay]


_RULES = {
    "MatMul": ShardedWalk._matmul,
    "MatMulSplit": ShardedWalk._matmul_split,
    "Gemm": ShardedWalk._gemm,
    "FusedAttentionHS": ShardedWalk._heads,
    "FusedAttention": ShardedWalk._lead,
    "DecodeAttention": ShardedWalk._lead,
    "LayerNormalization": ShardedWalk._layer_norm,
    "Softmax": ShardedWalk._softmax,
    "LogSoftmax": ShardedWalk._softmax,
    "Hardmax": ShardedWalk._softmax,
    "ReduceMean": ShardedWalk._reduce,
    "ReduceSum": ShardedWalk._reduce,
    "ReduceMax": ShardedWalk._reduce,
    "ReduceMin": ShardedWalk._reduce,
    "ReduceProd": ShardedWalk._reduce,
    "ReduceL1": ShardedWalk._reduce,
    "ReduceL2": ShardedWalk._reduce,
    "ReduceSumSquare": ShardedWalk._reduce,
    "ReduceLogSum": ShardedWalk._reduce,
    "ReduceLogSumExp": ShardedWalk._reduce,
    "ArgMax": ShardedWalk._arg,
    "ArgMin": ShardedWalk._arg,
    "TopK": ShardedWalk._topk,
    "Shape": ShardedWalk._shape,
    "Reshape": ShardedWalk._reshape,
    "Flatten": ShardedWalk._flatten,
    "Transpose": ShardedWalk._transpose,
    "Unsqueeze": ShardedWalk._unsqueeze,
    "Squeeze": ShardedWalk._squeeze,
    "Expand": ShardedWalk._expand,
    "Concat": ShardedWalk._concat,
    "Split": ShardedWalk._split,
    "Slice": ShardedWalk._slice,
    "Gather": ShardedWalk._gather_op,
}
