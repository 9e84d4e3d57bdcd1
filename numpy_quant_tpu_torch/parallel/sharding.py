"""Sharding rules and each rank's shard of a model's parameters (port of
``numpy_quant_tpu/parallel/sharding.py``).

Tensor-parallel rules follow the Megatron pattern for transformer
blocks: QKV and intermediate weights column-sharded, attention-output and
MLP-output weights row-sharded, so a block needs one all-reduce after
each row-sharded product. A spec is a tuple like a JAX ``PartitionSpec``:
one entry per leading axis, a mesh axis name or None; ``()`` replicates.
Where JAX's GSPMD inserts the collectives from these annotations, the
port's sharded walk (:mod:`.walk`) does.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..graph import Constant
from ..tensor import FTensor, PackedQTensor, QTensor

_VIT_TP_PATTERNS = [
    (re.compile(r"\.(query|key|value)\.weight_t$"), lambda nd: (None, "model")),
    (re.compile(r"\.(query|key|value)\.bias$"), lambda nd: ("model",)),
    (re.compile(r"\.attention\.output\.weight_t$"), lambda nd: ("model", None)),
    (re.compile(r"\.intermediate\.weight_t$"), lambda nd: (None, "model")),
    (re.compile(r"\.intermediate\.bias$"), lambda nd: ("model",)),
    (re.compile(r"(encoder\.layer\.\d+)\.output\.weight_t$"),
     lambda nd: ("model", None)),
]

_GPT_TP_PATTERNS = [
    (re.compile(r"\.attn\.c_attn\.weight$"), lambda nd: (None, "model")),
    (re.compile(r"\.attn\.c_attn\.bias$"), lambda nd: ("model",)),
    (re.compile(r"\.attn\.c_proj\.weight$"), lambda nd: ("model", None)),
    (re.compile(r"\.mlp\.c_fc\.weight$"), lambda nd: (None, "model")),
    (re.compile(r"\.mlp\.c_fc\.bias$"), lambda nd: ("model",)),
    (re.compile(r"\.mlp\.c_proj\.weight$"), lambda nd: ("model", None)),
    (re.compile(r"^lm_head\.weight_t$"), lambda nd: (None, "model")),
]

# grouped-query attention: keep tp <= num_key_value_heads so each rank
# holds whole kv heads; RMSNorm weights and the RoPE tables replicate
_LLAMA_TP_PATTERNS = [
    (re.compile(r"\.(q_proj|k_proj|v_proj)\.weight_t$"),
     lambda nd: (None, "model")),
    (re.compile(r"\.o_proj\.weight_t$"), lambda nd: ("model", None)),
    (re.compile(r"\.(gate_proj|up_proj)\.weight_t$"),
     lambda nd: (None, "model")),
    (re.compile(r"\.down_proj\.weight_t$"), lambda nd: ("model", None)),
    (re.compile(r"^lm_head\.weight_t$"), lambda nd: (None, "model")),
]


def _match(patterns, name: str, ndim: int) -> tuple:
    for pattern, spec in patterns:
        if pattern.search(name):
            return spec(ndim)
    return ()


def vit_tp_rules(name: str, ndim: int) -> tuple:
    """Spec of a ViT (or BERT: same emitter naming) parameter under the
    'model' axis; unmatched parameters replicate."""
    return _match(_VIT_TP_PATTERNS, name, ndim)


def gpt_tp_rules(name: str, ndim: int) -> tuple:
    """Spec of a GPT (models/gpt.py) parameter: merged-QKV c_attn and the
    vocab-parallel LM head column-shard, the c_proj projections
    row-shard."""
    return _match(_GPT_TP_PATTERNS, name, ndim)


def llama_tp_rules(name: str, ndim: int) -> tuple:
    """Spec of a LLaMA (models/llama.py) parameter: q/k/v and SwiGLU
    gate/up column-shard, o_proj/down_proj row-shard, vocab-parallel
    head."""
    return _match(_LLAMA_TP_PATTERNS, name, ndim)


def _segments(value: Constant):
    """The MatMulSplit segments of a merged weight, else None."""
    for node in value.outputs:
        if node.op == "MatMulSplit":
            return [int(s) for s in node.attrs["segments"]]
    return None


def param_specs(model, mesh, rules=None) -> dict:
    """{constant name: spec} as this rank places it. Packed payloads map
    to ``"column"`` (their last axis N sharded, as JAX shards both packed
    layouts and the [1, N] colsum) or ``"stacked"`` (a ``splitk_stacked``
    payload: one row group per rank, the global colsum replicated); a spec
    whose sharded axis does not divide replicates (JAX's ``fits``)."""

    def fits(spec, shape):
        for dim, ax in zip(shape, spec):
            if ax is not None and dim % mesh.shape[ax]:
                return False
        return True

    out = {}
    for value in model.values:
        if not isinstance(value, Constant) or value.data is None:
            continue
        data = value.data
        if not isinstance(data, (FTensor, QTensor, PackedQTensor)):
            continue
        spec = tuple(rules(value.name, 2 if isinstance(data, PackedQTensor)
                           else data.data.ndim)) if rules is not None else ()
        spec = tuple(ax if ax in mesh.shape and mesh.shape[ax] > 1 else None
                     for ax in spec)
        if not any(ax is not None for ax in spec):
            continue
        if isinstance(data, PackedQTensor):
            if data.layout == "splitk_stacked":
                if spec[0] is not None \
                        and data.planes.shape[0] == mesh.shape[spec[0]] \
                        and data.k % mesh.shape[spec[0]] == 0:
                    out[value.name] = ("stacked", spec[0])
                continue
            if len(spec) == 2 and spec[0] is None \
                    and fits(spec, data.shape) \
                    and _scale_fits(data.scale, 1, mesh.shape[spec[1]]):
                out[value.name] = ("column", spec[1])
            continue
        shape = tuple(data.data.shape)
        if not fits(spec, shape):
            continue
        segs = _segments(value)
        if segs is not None and any(s % mesh.shape[ax] for s in segs
                                    for ax in spec if ax is not None):
            continue
        if isinstance(data, QTensor) and not all(
                _scale_fits(data.scale, axis, mesh.shape[ax],
                            len(shape))
                for axis, ax in enumerate(spec) if ax is not None):
            continue
        out[value.name] = spec
    return out


def _scale_fits(scale, axis: int, parts: int, ndim: int = 2) -> bool:
    """A per-channel or grouped scale splits along ``axis`` with its
    payload (or is 1 there)."""
    if getattr(scale, "ndim", 0) == 0:
        return True
    s = np.asarray(scale)
    ax = s.ndim - (ndim - axis)
    return ax < 0 or s.shape[ax] == 1 or s.shape[ax] % parts == 0


def _chunk(t, axis: int, parts: int, index: int, segs=None):
    """``index``-th of ``parts`` contiguous pieces of ``t`` along ``axis``
    (torch tensor or host array); with ``segs``, the piece of every
    segment, concatenated (a merged Q/K/V weight keeps Q, K and V
    column-sharded each)."""
    if t is None or (getattr(t, "ndim", 0) == 0):
        return t
    axis = axis % t.ndim
    if t.shape[axis] == 1:
        return t
    if segs is not None and sum(segs) == t.shape[axis]:
        pieces, start = [], 0
        for s in segs:
            w = s // parts
            pieces.append(_narrow(t, axis, start + index * w, w))
            start += s
        return torch.cat(pieces, axis) if isinstance(t, torch.Tensor) \
            else np.concatenate(pieces, axis)
    w = t.shape[axis] // parts
    return _narrow(t, axis, index * w, w)


def _narrow(t, axis, start, length):
    if isinstance(t, torch.Tensor):
        return t.narrow(axis, start, length).contiguous()
    sl = [slice(None)] * t.ndim
    sl[axis] = slice(start, start + length)
    return np.ascontiguousarray(t[tuple(sl)])


def _scale_chunk(scale, axis: int, ndim: int, parts: int, index: int,
                 segs=None):
    if getattr(scale, "ndim", 0) == 0:
        return scale
    s = np.asarray(scale)
    ax = s.ndim - (ndim - axis)
    if ax < 0:
        return scale
    return _chunk(s, ax, parts, index, segs)


def local_shard(tensor, spec, mesh, segs=None, device=None):
    """This rank's piece of a placed constant ``tensor`` (the executor's
    FTensor / QTensor with its colsum / PackedQTensor) under ``spec``."""
    if isinstance(tensor, PackedQTensor):
        kind, ax = spec
        parts, r = mesh.shape[ax], mesh.index(ax)
        dev = device or tensor.planes.device
        if kind == "stacked":
            # this rank's row group, a split-K payload of K/S rows with the
            # global colsum: the walk unpacks it, runs the int dot and
            # all-reduces before the epilogue (as JAX runs a stacked shard)
            return PackedQTensor(tensor.planes[r].to(dev),
                                 tensor.colsum.to(dev), tensor.k // parts,
                                 tensor.n, tensor.bit_width, tensor.scale,
                                 "splitk")
        planes = _chunk(tensor.planes, -1, parts, r, segs)
        colsum = _chunk(tensor.colsum, -1, parts, r, segs)
        scale = _scale_chunk(tensor.scale, 1, 2, parts, r, segs)
        return PackedQTensor(planes.to(dev), colsum.to(dev), tensor.k,
                             planes.shape[-1], tensor.bit_width, scale,
                             tensor.layout)
    data = tensor.data
    ndim = data.ndim
    sharded = [(axis, ax) for axis, ax in enumerate(spec) if ax is not None]
    dev = device or data.device
    if isinstance(tensor, FTensor):
        for axis, ax in sharded:
            data = _chunk(data, axis, mesh.shape[ax], mesh.index(ax), segs)
        out = FTensor(data.to(dev))
        host = getattr(tensor, "host", None)
        if host is not None and not sharded:
            out.host = host
        return out
    scale, zp, colsum = tensor.scale, tensor.zero_point, tensor.colsum
    for axis, ax in sharded:
        p, r = mesh.shape[ax], mesh.index(ax)
        data = _chunk(data, axis, p, r, segs)
        scale = _scale_chunk(scale, axis, ndim, p, r, segs)
        if isinstance(zp, np.ndarray) and zp.ndim:
            zp = _scale_chunk(zp, axis, ndim, p, r, segs)
        if colsum is not None and axis == ndim - 1:
            # column shards slice the colsum; row shards keep it global
            colsum = _chunk(colsum, -1, p, r, segs)
    return QTensor(data.to(dev), tensor.bit_width, scale, zp,
                   colsum=None if colsum is None else colsum.to(dev))


def param_shardings(model, mesh, rules=None) -> dict:
    """{constant name: (spec, this rank's shard)} for every constant that
    does not replicate: column shards slice N, row shards slice K, packed
    payloads column-shard their last axis, ``splitk_stacked`` payloads
    take this rank's row group with the global colsum, and a merged
    Q/K/V weight (MatMulSplit) shards each segment."""
    specs = param_specs(model, mesh, rules)
    out = {}
    for value in model.values:
        spec = specs.get(value.name)
        if spec is None:
            continue
        placed = model._wrap_constant(value)
        out[value.name] = (spec, local_shard(placed, spec, mesh,
                                             _segments(value), mesh.device))
    return out


def shard_model(model, mesh, data_axis: str | None = "data",
                rules=None) -> None:
    """Attach a mesh to a Model: float inputs split their batch over
    ``data_axis``, parameters shard per ``rules`` (each rank keeps its
    own shard, placed on the mesh's device), and every captured forward,
    placed payload and device table is dropped. A model built on the
    CPU moves to the mesh's device with its shards."""
    model.mesh = mesh
    model.data_axis = data_axis if data_axis in mesh.shape else None
    model._shard_rules = rules
    model.invalidate_params()
    model.device = mesh.device
    model.__dict__.pop("_table_cache", None)


def model_axis_size(model) -> int:
    mesh = getattr(model, "mesh", None)
    ax = getattr(model, "model_axis", "model")
    if mesh is None or ax not in mesh.shape:
        return 1
    return mesh.shape[ax]


def kv_cache_layout(model, batch: int, heads: int) -> dict:
    """{axis: (mesh axis, 1)} of a [B, H, L, D] KV cache a sharded step
    model keeps per rank: B over the data axis and H over the model axis
    where they divide ({} unsharded)."""
    mesh = getattr(model, "mesh", None)
    lay = {}
    if mesh is None or mesh.size == 1:
        return lay
    ax = model.data_axis
    if ax is not None and mesh.shape[ax] > 1 and batch % mesh.shape[ax] == 0:
        lay[0] = (ax, 1)
    m = model.model_axis
    if model._shard_rules is not None and m in mesh.shape \
            and mesh.shape[m] > 1 and heads % mesh.shape[m] == 0:
        lay[1] = (m, 1)
    return lay


def local_shape(shape: tuple, layout: dict, mesh) -> tuple:
    """``shape`` of a global value as one rank holds it under ``layout``."""
    out = list(shape)
    for a, (m, _) in layout.items():
        out[a] //= mesh.shape[m]
    return tuple(out)
