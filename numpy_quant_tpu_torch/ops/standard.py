"""The standard ONNX op set beyond the transformer graphs' ops: elementwise
math, activations, comparisons and logic, reductions, indexing and
scatter, pooling and normalization, Pad/Resize, ConvTranspose, the
data-dependent host ops and the bit ops (port of the matching branches of
``numpy_quant_tpu/ops/registry.py``, branch by branch).

The domain rules are JAX's:

* host ``ITensor`` data stays on the host (numpy), so shape math folds
  before the device runs anything;
* device data stays on the device: floats as ``FTensor``, data-dependent
  integers (ArgMax/TopK indices, comparison and logical masks) as
  ``DITensor``. Nothing is read back to the host: an op whose output
  shape depends on device values (NonZero, Unique, Compress's condition,
  TopK's k, Range's bounds) raises as JAX's does.

Float formulas are JAX's expressions, not torch's functional defaults
(Softplus is ``logaddexp(x, 0)`` everywhere, LogSoftmax and
ReduceLogSumExp subtract the max as ``jax.nn``/``jax.scipy`` do, pools pad
explicitly). A division by a constant is a multiply by its float32
reciprocal (``_recip``), as XLA compiles it and as CUDA divides a tensor
by a Python scalar; other scalars are 0-d tensors of the data's dtype.

Scatters with host indices (ScatterElements, ScatterND) apply their
updates in rounds, each writing every destination at most once: round r
holds the r-th update of each destination in update order. That is the
order JAX's CPU executor applies them in (duplicates of ``set``: the last
update wins), and on CUDA it is deterministic, so a captured forward
equals the eager one bit for bit. The round plan of a constant index
tensor is built once and kept on it.
"""
from __future__ import annotations

import operator

import numpy as np
import torch
import torch.nn.functional as F

from ..intops import place
from ..tensor import DITensor, FTensor, ITensor, QTensor
from .conv import conv1d_ncl
from .interop import exec_device

# float-only unary ops: ONNX name -> torch function (JAX's
# _UNARY_FLOAT_FNS; the spec admits float inputs only)
UNARY_FLOAT_FNS = {
    "Exp": torch.exp, "Log": torch.log,
    "Sin": torch.sin, "Cos": torch.cos, "Tan": torch.tan,
    "Asin": torch.asin, "Acos": torch.acos, "Atan": torch.atan,
    "Sinh": torch.sinh, "Cosh": torch.cosh,
    "Asinh": torch.asinh, "Acosh": torch.acosh, "Atanh": torch.atanh,
    "Floor": torch.floor, "Ceil": torch.ceil,
    "Reciprocal": torch.reciprocal,
}


def _s(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 host scalar as a 0-d tensor of ``like``'s dtype and
    device (an exact divisor on CUDA)."""
    return torch.full((), float(np.float32(value)), dtype=like.dtype,
                      device=like.device)


def _recip(value, like: torch.Tensor) -> torch.Tensor:
    """1 / value rounded to float32, as a 0-d tensor of ``like``'s dtype:
    the factor XLA multiplies by where JAX divides by a constant."""
    return _s(np.float32(1.0) / np.float32(value), like)


def _str(attrs, key, default):
    v = attrs.get(key, default)
    return v.decode() if isinstance(v, bytes) else v


def _opt(inputs, i):
    return inputs[i] if len(inputs) > i and inputs[i] is not None else None


def _dev(t) -> torch.Tensor:
    """A tensor's values on the device: FTensor/DITensor data, an
    ITensor's int32 copy (``jnp.asarray`` of a host int64 array with x64
    off)."""
    if isinstance(t, ITensor):
        return place(t.data, exec_device(), torch.int32)
    if isinstance(t, QTensor):
        raise ValueError("a quantized tensor reached a float op")
    return t.data


def _host_float(arr) -> FTensor:
    return FTensor(place(np.asarray(arr, np.float32), exec_device(),
                         torch.float32))


def _axes(inputs, attrs):
    """Reduction axes: the opset-18 input, else the attribute; none or
    empty means every axis (None)."""
    if len(inputs) > 1 and inputs[1] is not None:
        axes = tuple(int(a) for a in inputs[1].data)
    else:
        axes = tuple(int(a) for a in attrs.get("axes", ()))
    return axes or None


def _dims(d: torch.Tensor, axes):
    return tuple(range(d.ndim)) if axes is None else axes


def _np_axes(axes):
    return None if axes is None else tuple(axes)


def _logaddexp0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|)), NaN kept."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = torch.maximum(x, zero) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def _gather_nd(data, indices, batch_dims: int, xp):
    """ONNX GatherND: index the leading ``indices.shape[-1]`` dims of
    ``data`` (after ``batch_dims`` shared batch axes) by the tuples in
    ``indices``; numpy for the host fold, torch on the device."""
    k = indices.shape[-1]
    loc_shape = indices.shape[:-1]
    loc = []
    for d in range(batch_dims):
        shape = [1] * len(loc_shape)
        shape[d] = data.shape[d]
        ar = np.arange(data.shape[d]) if xp is np \
            else torch.arange(data.shape[d], device=data.device)
        loc.append(ar.reshape(shape))
    for i in range(k):
        loc.append(indices[..., i])
    return data[tuple(loc)]


def _resize_coords(out_size: int, in_size: int, scale: float, ctm: str):
    """Source coordinate of each output index per the ONNX Resize
    coordinate_transformation_mode."""
    i = np.arange(out_size, dtype=np.float64)
    if ctm == "half_pixel":
        return (i + 0.5) / scale - 0.5
    if ctm == "pytorch_half_pixel":
        return (i + 0.5) / scale - 0.5 if out_size > 1 else np.zeros(1)
    if ctm == "asymmetric":
        return i / scale
    if ctm == "align_corners":
        if out_size == 1:
            return np.zeros(1)
        return i * (in_size - 1) / (out_size - 1)
    raise ValueError(f"Resize coordinate_transformation_mode {ctm!r} "
                     "not supported")


def resize(inputs, attrs):
    """ONNX Resize (nearest/linear), one axis at a time: a gather
    (nearest) or a two-gather lerp (linear) with host-computed indices
    and weights. Scales and sizes are read on the host (graph
    constants)."""
    x = inputs[0]
    rank = len(x.data.shape)
    mode = _str(attrs, "mode", "nearest")
    ctm = _str(attrs, "coordinate_transformation_mode", "half_pixel")
    nearest_mode = _str(attrs, "nearest_mode", "round_prefer_floor")
    if mode not in ("nearest", "linear"):
        raise ValueError(f"Resize mode {mode!r} not supported")
    if int(attrs.get("antialias", 0)):
        raise ValueError("Resize antialias not supported")
    if int(attrs.get("exclude_outside", 0)):
        raise ValueError("Resize exclude_outside not supported")
    karp = _str(attrs, "keep_aspect_ratio_policy", "stretch")
    if karp != "stretch":
        raise ValueError(f"Resize keep_aspect_ratio_policy {karp!r} "
                         "not supported")
    axes = attrs.get("axes")
    axes = list(range(rank)) if axes is None \
        else [int(a) % rank for a in axes]
    # [x, roi, scales, sizes]; roi only matters in tf_crop_and_resize
    scales = sizes = None
    if _opt(inputs, 2) is not None:
        host = getattr(inputs[2], "host", None)
        if host is None:
            raise ValueError(
                "Resize scales must be graph constants (static shapes)")
        if host.size:
            scales = host.astype(np.float64).reshape(-1)
    if _opt(inputs, 3) is not None:
        arr = np.asarray(inputs[3].data)
        if arr.size:
            sizes = arr.astype(np.int64).reshape(-1)
    if scales is None and sizes is None:
        raise ValueError("Resize needs scales or sizes")

    in_shape = [int(d) for d in x.data.shape]
    out_shape = list(in_shape)
    ax_scale = {}
    for i, a in enumerate(axes):
        if sizes is not None:
            out_shape[a] = int(sizes[i])
            ax_scale[a] = out_shape[a] / in_shape[a]
        else:
            out_shape[a] = int(np.floor(in_shape[a] * scales[i]))
            ax_scale[a] = float(scales[i])

    host_data = isinstance(x, ITensor)
    # JAX's int32 host data lerps in float32
    y = x.data.astype(np.float32) if host_data and mode == "linear" \
        else x.data
    for a in range(rank):
        if out_shape[a] == in_shape[a] and ax_scale.get(a, 1.0) == 1.0:
            continue
        coords = _resize_coords(out_shape[a], in_shape[a], ax_scale[a], ctm)
        if mode == "nearest":
            if nearest_mode == "floor":
                idx = np.floor(coords)
            elif nearest_mode == "ceil":
                idx = np.ceil(coords)
            elif nearest_mode == "round_prefer_ceil":
                idx = np.floor(coords + 0.5)
            else:  # round_prefer_floor (default)
                idx = np.ceil(coords - 0.5)
            idx = np.clip(idx, 0, in_shape[a] - 1).astype(np.int64)
            y = np.take(y, idx, axis=a) if host_data \
                else torch.index_select(y, a, place(idx, y.device,
                                                    torch.int64))
        else:
            # clamp the source coordinate before the floor and the lerp
            coords = np.clip(coords, 0.0, in_shape[a] - 1)
            i0 = np.floor(coords).astype(np.int64)
            i1 = np.clip(i0 + 1, 0, in_shape[a] - 1)
            w = (coords - i0).astype(np.float32)
            wshape = [1] * rank
            wshape[a] = -1
            if host_data:
                wj = w.reshape(wshape)
                y = np.take(y, i0, axis=a) * (1.0 - wj) \
                    + np.take(y, i1, axis=a) * wj
            else:
                wj = place(w.reshape(wshape), y.device, torch.float32)
                y0 = torch.index_select(y, a, place(i0, y.device,
                                                    torch.int64))
                y1 = torch.index_select(y, a, place(i1, y.device,
                                                    torch.int64))
                y = y0 * (1.0 - wj) + y1 * wj
    if host_data:
        # output type == input type: a linear resize of integers rounds
        if mode == "linear":
            y = np.rint(y)
        return ITensor(y.astype(np.int64))
    return FTensor(y)


def _pad(inputs, attrs):
    x = inputs[0]
    mode = _str(attrs, "mode", "constant")
    if mode not in ("constant", "edge", "reflect", "wrap"):
        raise ValueError(f"Pad mode {mode!r} not supported")
    rank = len(x.data.shape)
    if _opt(inputs, 1) is not None:
        pads = np.asarray(inputs[1].data, np.int64).reshape(-1)
    else:  # opset < 11: pads as an attribute
        pads = np.asarray(attrs["pads"], np.int64).reshape(-1)
    # [x, pads, constant_value, axes]
    cval = _opt(inputs, 2)
    if _opt(inputs, 3) is not None:
        axes = [int(a) % rank
                for a in np.asarray(inputs[3].data).reshape(-1)]
    else:
        axes = list(range(rank))
    before = {a: int(pads[i]) for i, a in enumerate(axes)}
    after = {a: int(pads[i + len(axes)]) for i, a in enumerate(axes)}
    widths = [(max(before.get(a, 0), 0), max(after.get(a, 0), 0))
              for a in range(rank)]
    if isinstance(x, ITensor):
        kw = {}
        if mode == "constant":
            kw = {"constant_values": 0 if cval is None else
                  int(np.asarray(cval.data).reshape(-1)[0])}
        y = np.pad(x.data, widths, mode=mode, **kw)
    else:
        d = x.data
        if mode == "constant":
            out_shape = tuple(s + b + e for s, (b, e) in zip(d.shape, widths))
            if cval is None:
                y = torch.zeros(out_shape, dtype=d.dtype, device=d.device)
            else:
                cv = _dev(cval).reshape(()).to(d.dtype)
                y = cv.expand(out_shape).clone()
            y[tuple(slice(b, b + s) for s, (b, _) in zip(d.shape, widths))] \
                = d
        else:
            # numpy's pad of the index ramp is each axis' source index
            y = d
            for a, (b, e) in enumerate(widths):
                if b or e:
                    src = np.pad(np.arange(d.shape[a]), (b, e), mode=mode)
                    y = torch.index_select(y, a, place(src, d.device,
                                                       torch.int64))
    # negative pads crop
    if any(before.get(a, 0) < 0 or after.get(a, 0) < 0
           for a in range(rank)):
        sl = tuple(slice(-min(before.get(a, 0), 0),
                         y.shape[a] + min(after.get(a, 0), 0))
                   for a in range(rank))
        y = y[sl]
    return [ITensor(y) if isinstance(x, ITensor) else FTensor(y)]


def _cached(t, key, build):
    """``build()``, kept on the host tensor ``t`` under ``key`` (a
    constant index tensor serves every forward; the first, eager walk
    builds what the captured one reads)."""
    cache = t.__dict__.setdefault("_plans", {})
    if key not in cache:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("an index plan was built during a CUDA graph "
                               "capture; the warm-up walk builds each one")
        cache[key] = build()
    return cache[key]


def _scatter_rounds(lin: np.ndarray, device):
    """Host destinations ``lin`` (one per update, in update order) ->
    [(destinations, update positions)] per round on ``device``: round r
    holds the r-th update of each destination."""
    order = np.argsort(lin, kind="stable")
    srt = lin[order]
    starts = np.flatnonzero(np.r_[True, srt[1:] != srt[:-1]])
    first = np.repeat(starts, np.diff(np.r_[starts, srt.size]))
    rank = np.empty_like(order)
    rank[order] = np.arange(srt.size) - first
    rounds = []
    for r in range(int(rank.max(initial=-1)) + 1):
        pos = np.flatnonzero(rank == r)
        rounds.append((torch.from_numpy(lin[pos]).to(device),
                       torch.from_numpy(pos).to(device)))
    return rounds


_ROW_REDUCE = {"mul": torch.mul, "max": torch.maximum, "min": torch.minimum}


def _scatter_rows(rows: torch.Tensor, dest, upd: torch.Tensor, reduction,
                  rounds=None) -> torch.Tensor:
    """rows [R, S] with updates upd [U, S] scattered into rows ``dest``
    (U destinations) by ``reduction`` (none/add/mul/max/min); in rounds
    (``_scatter_rounds``) where the destinations are host values."""
    out = rows.clone()
    upd = upd.to(out.dtype)

    def apply(idx, u):
        if reduction == "add":
            out.index_add_(0, idx, u)
        elif reduction in _ROW_REDUCE:
            # destinations of a round are distinct: read, combine, write
            cur = torch.index_select(out, 0, idx)
            out.index_copy_(0, idx, _ROW_REDUCE[reduction](cur, u))
        else:
            out.index_copy_(0, idx, u)

    if rounds is None:
        dest = dest.reshape(-1).to(torch.int64)
        if reduction in _ROW_REDUCE:
            red = {"mul": "prod", "max": "amax", "min": "amin"}[reduction]
            out.index_reduce_(0, dest, upd, red)
        else:
            apply(dest, upd)
        return out
    for idx, pos in rounds:
        apply(idx, torch.index_select(upd, 0, pos))
    return out


def _np_scatter(out, loc, upd, reduction):
    fn = {"add": np.add, "mul": np.multiply, "max": np.maximum,
          "min": np.minimum}.get(reduction)
    if fn is None:
        out[loc] = upd
    else:
        fn.at(out, loc, upd)
    return out


def _elements_lin(idx: np.ndarray, shape, axis: int) -> np.ndarray:
    """Linear element index into ``shape`` of each index of a
    GatherElements/ScatterElements ``idx`` along ``axis``."""
    idx = np.where(idx < 0, idx + shape[axis], idx)
    grids = list(np.indices(idx.shape))
    grids[axis] = idx
    return np.ravel_multi_index(tuple(grids), shape).reshape(-1)


def scatter_elements(inputs, attrs):
    data, indices, updates = inputs[0], inputs[1], inputs[2]
    axis = int(attrs.get("axis", 0))
    reduction = _str(attrs, "reduction", "none")
    if isinstance(data, QTensor):
        raise ValueError("ScatterElements on QTensor not supported")
    axis %= len(data.data.shape)
    if isinstance(data, ITensor):
        idx = np.asarray(indices.data)
        grids = list(np.indices(idx.shape))
        grids[axis] = idx
        return [ITensor(_np_scatter(np.array(data.data, copy=True),
                                    tuple(grids), updates.data, reduction))]
    d = data.data
    shape = tuple(d.shape)
    lin = _cached(indices, ("elements", shape, axis, str(d.device)),
                  lambda: _elements_lin(np.asarray(indices.data), shape, axis))
    rounds = _cached(indices, ("rounds", shape, axis, str(d.device)),
                     lambda: _scatter_rounds(lin, d.device))
    out = _scatter_rows(d.reshape(-1, 1), None,
                        updates.data.reshape(-1, 1), reduction, rounds)
    return [FTensor(out.reshape(shape))]


def gather_elements(inputs, attrs):
    data, indices = inputs[0], inputs[1]
    axis = int(attrs.get("axis", 0)) % len(data.data.shape)
    idx = np.asarray(indices.data)
    if isinstance(data, FTensor):
        d = data.data
        lin = _cached(indices, ("elements", tuple(d.shape), axis,
                                str(d.device)),
                      lambda: _elements_lin(idx, tuple(d.shape), axis))
        flat = torch.index_select(d.reshape(-1), 0,
                                  place(lin, d.device, torch.int64))
        return [FTensor(flat.reshape(idx.shape))]
    grids = list(np.indices(idx.shape))
    grids[axis] = idx
    return [ITensor(np.asarray(data.data)[tuple(grids)])]


def scatter_nd(inputs, attrs):
    x, idx, upd = inputs[0], inputs[1], inputs[2]
    red = _str(attrs, "reduction", "none")
    k = int(idx.data.shape[-1])
    if isinstance(x, ITensor) and isinstance(idx, ITensor):
        loc = tuple(np.asarray(idx.data)[..., i] for i in range(k))
        return [ITensor(_np_scatter(np.array(x.data), loc, upd.data, red))]
    d = _dev(x)
    lead = tuple(d.shape[:k])
    rows = d.reshape(int(np.prod(lead, dtype=np.int64)), -1)
    u = _dev(upd).reshape(-1, rows.shape[1])
    if isinstance(idx, ITensor):
        def build():
            i = np.asarray(idx.data).reshape(-1, k)
            i = np.where(i < 0, i + np.array(lead), i)
            return _scatter_rounds(np.ravel_multi_index(i.T, lead), d.device)
        rounds = _cached(idx, ("nd", lead, str(d.device)), build)
        out = _scatter_rows(rows, None, u, red, rounds)
    else:
        i = idx.data.reshape(-1, k).to(torch.int64)
        i = torch.where(i < 0, i + torch.tensor(lead, device=i.device), i)
        strides = torch.tensor(
            [int(np.prod(lead[j + 1:], dtype=np.int64)) for j in range(k)],
            device=i.device)
        out = _scatter_rows(rows, (i * strides).sum(-1), u, red)
    out = out.reshape(d.shape)
    return [FTensor(out) if isinstance(x, FTensor) else DITensor(out)]


def _topk(inputs, attrs):
    x = inputs[0]
    if not isinstance(inputs[1], ITensor):
        raise ValueError("TopK k must be a graph constant (static output "
                         "shapes)")
    k = int(np.asarray(inputs[1].data).reshape(-1)[0])
    axis = int(attrs.get("axis", -1))
    largest = bool(attrs.get("largest", 1))
    d = x.data
    axis %= d.ndim
    moved = torch.movedim(d, axis, -1)
    # lax.top_k's order: descending in IEEE total order (+0.0 above
    # -0.0), the lower index first on ties -- a stable sort of the float
    # bits as ordered integers (the smallest: the same on -x)
    keyed = (moved if largest else -moved).to(torch.float32)
    bits = keyed.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    vals = torch.gather(moved, -1, idx)
    return [FTensor(torch.movedim(vals, -1, axis)),
            DITensor(torch.movedim(idx, -1, axis))]


def _arg_reduce(op, inputs, attrs):
    x = inputs[0]
    axis = int(attrs.get("axis", 0))
    keepdims = bool(attrs.get("keepdims", 1))
    last = bool(attrs.get("select_last_index", 0))
    if isinstance(x, ITensor):
        fn = np.argmax if op == "ArgMax" else np.argmin
        d = np.flip(x.data, axis) if last else x.data
        idx = fn(d, axis=axis)
        if last:
            idx = x.data.shape[axis] - 1 - idx
        if keepdims:
            idx = np.expand_dims(idx, axis)
        return [ITensor(idx)]
    fn = torch.argmax if op == "ArgMax" else torch.argmin
    d = x.data
    if last:
        idx = d.shape[axis] - 1 - fn(torch.flip(d, (axis,)), dim=axis)
    else:
        idx = fn(d, dim=axis)
    if keepdims:
        idx = idx.unsqueeze(axis)
    return [DITensor(idx)]


def _pool(op, inputs, attrs):
    x = inputs[0].data  # [B, C, H, W]
    kh, kw = (int(k) for k in attrs["kernel_shape"])
    sh, sw = (int(s) for s in attrs.get("strides", (1, 1)))
    ph0, pw0, ph1, pw1 = (int(p) for p in attrs.get("pads", (0, 0, 0, 0)))
    pads = (pw0, pw1, ph0, ph1)
    if op == "MaxPool":
        xp = F.pad(x, pads, value=float("-inf"))
        return [FTensor(F.max_pool2d(xp, (kh, kw), (sh, sw)))]
    # window sums, then JAX's divisor: the window size, or (pads left
    # out, count_include_pad=0) the count of real elements
    sums = F.avg_pool2d(F.pad(x, pads), (kh, kw), (sh, sw),
                        divisor_override=1)
    if int(attrs.get("count_include_pad", 0)) or pads == (0, 0, 0, 0):
        return [FTensor(sums * _recip(kh * kw, sums))]
    ones = np.pad(np.ones(x.shape[2:], np.float32), ((ph0, ph1), (pw0, pw1)))
    win = np.lib.stride_tricks.sliding_window_view(ones, (kh, kw))
    counts = win[::sh, ::sw].sum(axis=(2, 3), dtype=np.float32)
    return [FTensor(sums / place(counts, x.device, torch.float32)
                    .to(sums.dtype))]


def _conv_transpose(inputs, attrs):
    x, w = inputs[0], inputs[1]
    b = _opt(inputs, 2)
    xd, wd = x.data, w.data.to(x.data.dtype)
    n_sp = xd.ndim - 2
    strides = [int(s) for s in attrs.get("strides", [1] * n_sp)]
    dil = [int(d) for d in attrs.get("dilations", [1] * n_sp)]
    group = int(attrs.get("group", 1))
    out_pad = [int(p) for p in attrs.get("output_padding", [0] * n_sp)]
    if "output_shape" in attrs:
        raise ValueError("ConvTranspose output_shape attr not supported "
                         "(use pads/output_padding)")
    ap = _str(attrs, "auto_pad", "NOTSET")
    if ap not in ("NOTSET", ""):
        raise ValueError(f"ConvTranspose auto_pad {ap!r} not supported")
    pads = [int(p) for p in attrs.get("pads", [0] * (2 * n_sp))]
    fn = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
          3: F.conv_transpose3d}[n_sp]
    # the full transposed conv, then ONNX's pads crop (and
    # output_padding extends) the trailing and leading edges
    y = fn(xd, wd, None, stride=strides, dilation=dil, groups=group)
    crop = []
    for i in reversed(range(n_sp)):
        crop += [-pads[i], out_pad[i] - pads[n_sp + i]]
    y = F.pad(y, crop)
    if b is not None:
        y = y + b.data.reshape((1, -1) + (1,) * n_sp)
    return [FTensor(y)]


def _group_norm(inputs, attrs):
    x, scale, bias = inputs[0], inputs[1], inputs[2]
    eps = float(attrs.get("epsilon", 1e-5))
    groups = int(attrs["num_groups"])
    xd = x.data
    n, c = xd.shape[0], xd.shape[1]
    sp = tuple(xd.shape[2:])
    xg = xd.reshape(n, groups, c // groups, *sp)
    red = tuple(range(2, xg.ndim))
    mean = torch.mean(xg, dim=red, keepdim=True)
    d = xg - mean
    var = torch.mean(d * d, dim=red, keepdim=True)
    y = (d / torch.sqrt(var + _s(eps, var))).reshape(xd.shape)
    sd, bd = scale.data, bias.data
    if sd.shape[0] == groups and groups != c:
        # opset-18 per-group affine; opset-21 made it per-channel
        sd = torch.repeat_interleave(sd, c // groups)
        bd = torch.repeat_interleave(bd, c // groups)
    bshape = (1, -1) + (1,) * len(sp)
    return [FTensor(y * sd.reshape(bshape) + bd.reshape(bshape))]


def _instance_norm(inputs, attrs):
    x, scale, bias = inputs[0], inputs[1], inputs[2]
    eps = float(attrs.get("epsilon", 1e-5))
    xd = x.data
    sp = tuple(range(2, xd.ndim))
    mean = torch.mean(xd, dim=sp, keepdim=True)
    d = xd - mean
    var = torch.mean(d * d, dim=sp, keepdim=True)
    bshape = (1, -1) + (1,) * len(sp)
    y = d / torch.sqrt(var + _s(eps, var)) * scale.data.reshape(bshape) \
        + bias.data.reshape(bshape)
    return [FTensor(y)]


def _batch_norm(inputs, attrs):
    """Inference form (saved statistics) over channel axis 1 of any rank
    >= 2; training mode raises."""
    if int(attrs.get("training_mode", 0)):
        raise ValueError("BatchNormalization training_mode=1 is not "
                         "supported (inference framework)")
    x, scale, bias, mean, var = inputs[:5]
    eps = float(attrs.get("epsilon", 1e-5))
    xd = x.data
    bshape = (1, -1) + (1,) * (xd.ndim - 2)
    k = scale.data / torch.sqrt(var.data + _s(eps, var.data))
    y = (xd - mean.data.reshape(bshape)) * k.reshape(bshape) \
        + bias.data.reshape(bshape)
    return [FTensor(y)]


def _gelu(inputs, attrs):
    x = inputs[0]
    if _str(attrs, "approximate", "none") == "tanh":
        xd = x.data
        inner = _s(np.sqrt(2.0 / np.pi), xd) \
            * (xd + _s(0.044715, xd) * xd * xd * xd)
        return [FTensor(_s(0.5, xd) * xd * (1.0 + torch.tanh(inner)))]
    half = FTensor(_s(0.5, x.data))
    one = FTensor(_s(1.0, x.data))
    u = x * FTensor(_s(1.0 / np.sqrt(2.0), x.data))
    return [x * half * (u.erf() + one)]


def _clip(inputs, attrs):
    x = inputs[0]
    lo = inputs[1] if _opt(inputs, 1) is not None else attrs.get("min")
    hi = inputs[2] if _opt(inputs, 2) is not None else attrs.get("max")
    if isinstance(x, ITensor):
        y = x.data
        if lo is not None:
            y = np.maximum(y, np.asarray(getattr(lo, "data", lo), np.int64))
        if hi is not None:
            y = np.minimum(y, np.asarray(getattr(hi, "data", hi), np.int64))
        return [ITensor(y)]
    y = x.data

    def bound(v):
        if isinstance(v, (FTensor, ITensor, DITensor)):
            return _dev(v).to(y.dtype)
        return _s(v, y)

    if lo is not None:
        y = torch.maximum(y, bound(lo))
    if hi is not None:
        y = torch.minimum(y, bound(hi))
    return [FTensor(y)]


def _reduce_sum(inputs, attrs):
    x = inputs[0]
    axes = _axes(inputs, attrs)
    keepdims = bool(attrs.get("keepdims", 1))
    if isinstance(x, ITensor):
        return [ITensor(np.sum(x.data, axis=_np_axes(axes),
                               keepdims=keepdims))]
    d = x.data
    return [FTensor(torch.sum(d, dim=_dims(d, axes), keepdim=keepdims))]


def _reduce_min_max(op, inputs, attrs):
    x = inputs[0]
    axes = _axes(inputs, attrs)
    keepdims = bool(attrs.get("keepdims", 1))
    if isinstance(x, ITensor):
        fn = np.max if op == "ReduceMax" else np.min
        return [ITensor(fn(x.data, axis=_np_axes(axes), keepdims=keepdims))]
    fn = torch.amax if op == "ReduceMax" else torch.amin
    d = x.data
    return [FTensor(fn(d, dim=_dims(d, axes), keepdim=keepdims))]


def _reduce_extra(op, inputs, attrs):
    x = inputs[0]
    axes = _axes(inputs, attrs)
    keepdims = bool(attrs.get("keepdims", 1))
    if isinstance(x, ITensor):
        d, ax = x.data, _np_axes(axes)
        if op == "ReduceProd":
            return [ITensor(np.prod(d, axis=ax, keepdims=keepdims))]
        if op == "ReduceL1":
            return [ITensor(np.sum(np.abs(d), axis=ax, keepdims=keepdims))]
        if op == "ReduceSumSquare":
            return [ITensor(np.sum(d * d, axis=ax, keepdims=keepdims))]
        raise ValueError(f"{op} on host integer data is not defined")
    d = x.data
    dims = _dims(d, axes)
    if op == "ReduceProd":
        y = d
        for a in sorted((a % d.ndim for a in dims), reverse=True):
            y = torch.prod(y, dim=a, keepdim=keepdims)
    elif op == "ReduceL1":
        y = torch.sum(torch.abs(d), dim=dims, keepdim=keepdims)
    elif op == "ReduceL2":
        y = torch.sqrt(torch.sum(d * d, dim=dims, keepdim=keepdims))
    elif op == "ReduceSumSquare":
        y = torch.sum(d * d, dim=dims, keepdim=keepdims)
    elif op == "ReduceLogSum":
        y = torch.log(torch.sum(d, dim=dims, keepdim=keepdims))
    else:  # ReduceLogSumExp: jax.scipy.special.logsumexp's expression
        amax = torch.amax(d, dim=dims, keepdim=True)
        amax = torch.where(torch.isfinite(amax), amax,
                           torch.zeros((), dtype=d.dtype, device=d.device))
        s = torch.sum(torch.exp(d - amax), dim=dims, keepdim=keepdims)
        if not keepdims:
            amax = amax.reshape(s.shape)
        y = torch.log(torch.abs(s)) + amax
    return [FTensor(y)]


def _flatten(inputs, attrs):
    x = inputs[0]
    axis = int(attrs.get("axis", 1))
    dims = x.shape if isinstance(x, QTensor) \
        else tuple(int(d) for d in x.shape.data)
    lead = int(np.prod(dims[:axis])) if axis > 0 else 1
    return [x.reshape(ITensor(np.array([lead, -1], dtype=np.int64)))]


def _squeeze(inputs, attrs):
    x = inputs[0]
    if _opt(inputs, 1) is not None:
        axes = tuple(int(a) for a in inputs[1].data)
    elif "axes" in attrs:
        axes = tuple(int(a) for a in attrs["axes"])
    else:
        axes = None
    dims = x.shape if isinstance(x, QTensor) \
        else tuple(int(d) for d in x.shape.data)
    if axes is None:
        new = [d for d in dims if d != 1]
    else:
        axes = tuple(a % len(dims) for a in axes)
        new = [d for i, d in enumerate(dims) if i not in axes]
    return [x.reshape(ITensor(np.array(new, dtype=np.int64)))]


def _pow(inputs, attrs):
    a, b = inputs[0], inputs[1]
    if isinstance(a, ITensor):
        return [ITensor(np.power(a.data, np.asarray(b.data, np.int64)))]
    return [FTensor(torch.pow(a.data, _dev(b).to(a.data.dtype)))]


def _unary_host_or_float(np_fn, torch_fn):
    def op(inputs, attrs):
        x = inputs[0]
        if isinstance(x, ITensor):
            return [ITensor(np_fn(x.data))]
        return [FTensor(torch_fn(x.data))]
    return op


def _sign(inputs, attrs):
    x = inputs[0]
    if isinstance(x, ITensor):
        return [ITensor(np.sign(x.data))]
    if isinstance(x, DITensor):
        return [DITensor(torch.sign(x.data))]
    return [FTensor(torch.sign(x.data))]


def _mod(inputs, attrs):
    a, b = inputs[0], inputs[1]
    fmod = bool(attrs.get("fmod", 0))
    if isinstance(a, ITensor) and isinstance(b, ITensor):
        y = np.fmod(a.data, b.data) if fmod else np.mod(a.data, b.data)
        return [ITensor(np.asarray(y, np.int64))]
    # jnp.mod is Python's modulo (the divisor's sign): torch.remainder
    fn = torch.fmod if fmod else torch.remainder
    y = fn(_dev(a), _dev(b))
    return [FTensor(y) if y.is_floating_point() else DITensor(y)]


_COMPARE = {"Greater": operator.gt, "Less": operator.lt,
            "GreaterOrEqual": operator.ge, "LessOrEqual": operator.le}


def _compare(op, inputs, attrs):
    fn = _COMPARE[op]
    a, b = inputs[0], inputs[1]
    if isinstance(a, ITensor) and isinstance(b, ITensor):
        return [ITensor(np.asarray(fn(a.data, b.data), np.int64))]
    return [DITensor(fn(_dev(a), _dev(b)).to(torch.int32))]


def _not(inputs, attrs):
    x = inputs[0]
    if isinstance(x, ITensor):
        return [ITensor(np.asarray(x.data == 0, np.int64))]
    return [DITensor((_dev(x) == 0).to(torch.int32))]


def _logical(op, inputs, attrs):
    a, b = inputs[0], inputs[1]
    if isinstance(a, ITensor) and isinstance(b, ITensor):
        av, bv = a.data != 0, b.data != 0
    else:
        av, bv = _dev(a) != 0, _dev(b) != 0
    y = {"And": av & bv, "Or": av | bv, "Xor": av ^ bv}[op]
    if isinstance(y, np.ndarray):
        return [ITensor(np.asarray(y, np.int64))]
    return [DITensor(y.to(torch.int32))]


def _is_nan_inf(op, inputs, attrs):
    x = _dev(inputs[0])
    if op == "IsNaN":
        y = torch.isnan(x)
    else:
        pos = bool(attrs.get("detect_positive", 1))
        neg = bool(attrs.get("detect_negative", 1))
        y = torch.isinf(x)
        if pos and not neg:
            y = y & (x > 0)
        elif neg and not pos:
            y = y & (x < 0)
        elif not (pos or neg):
            y = torch.zeros_like(y)
    return [DITensor(y.to(torch.int32))]


def _log_softmax(inputs, attrs):
    # jax.nn.log_softmax: shifted - log(sum(exp(shifted)))
    x = inputs[0].data
    axis = int(attrs.get("axis", -1))
    shifted = x - torch.amax(x, dim=axis, keepdim=True)
    return [FTensor(shifted - torch.log(torch.sum(torch.exp(shifted),
                                                  dim=axis, keepdim=True)))]


def _gather_nd_op(inputs, attrs):
    x, idx = inputs[0], inputs[1]
    batch_dims = int(attrs.get("batch_dims", 0))
    if isinstance(x, ITensor) and isinstance(idx, ITensor):
        return [ITensor(_gather_nd(x.data, idx.data, batch_dims, np))]
    i = place(idx.data, exec_device(), torch.int64) \
        if isinstance(idx, ITensor) else idx.data.to(torch.int64)
    y = _gather_nd(_dev(x), i.to(_dev(x).device), batch_dims, torch)
    if isinstance(x, (ITensor, DITensor)):
        return [DITensor(y)]
    return [FTensor(y)]


def _depth_space(op, inputs, attrs):
    x = inputs[0]
    bs = int(attrs["blocksize"])
    n, c, h, w = (int(dim) for dim in x.shape.data)
    d = x.data
    perm = (lambda a, p: a.transpose(p)) if isinstance(x, ITensor) \
        else (lambda a, p: a.permute(*p))
    if op == "SpaceToDepth":
        y = perm(d.reshape(n, c, h // bs, bs, w // bs, bs),
                 (0, 3, 5, 1, 2, 4)).reshape(n, c * bs * bs, h // bs, w // bs)
    else:
        if _str(attrs, "mode", "DCR") == "DCR":
            y = perm(d.reshape(n, bs, bs, c // (bs * bs), h, w),
                     (0, 3, 4, 1, 5, 2))
        else:  # CRD
            y = perm(d.reshape(n, c // (bs * bs), bs, bs, h, w),
                     (0, 1, 4, 2, 5, 3))
        y = y.reshape(n, c // (bs * bs), h * bs, w * bs)
    return [ITensor(y) if isinstance(x, ITensor) else FTensor(y)]


def _sum_mean(op, inputs, attrs):
    y = inputs[0].data
    for t in inputs[1:]:
        y = y + t.data
    if op == "Mean":
        y = y * _recip(len(inputs), y)
    return [FTensor(y)]


def _hardmax(inputs, attrs):
    x = inputs[0].data
    axis = int(attrs.get("axis", -1)) % x.ndim
    am = torch.argmax(x, dim=axis, keepdim=True)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    iota = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    return [FTensor((iota == am).to(torch.float32))]


def _shrink(inputs, attrs):
    x = inputs[0].data
    bias = _s(attrs.get("bias", 0.0), x)
    lambd = _s(attrs.get("lambd", 0.5), x)
    zero = _s(0.0, x)
    return [FTensor(torch.where(x < -lambd, x + bias,
                                torch.where(x > lambd, x - bias, zero)))]


def _celu(inputs, attrs):
    x = inputs[0].data
    alpha = attrs.get("alpha", 1.0)
    zero = _s(0.0, x)
    return [FTensor(torch.maximum(x, zero) + torch.minimum(
        zero, _s(alpha, x) * (torch.exp(x * _recip(alpha, x)) - 1.0)))]


def _eye_like(inputs, attrs):
    x = inputs[0]
    n, m = (int(d) for d in x.shape.data)
    eye = np.eye(n, m, k=int(attrs.get("k", 0)))
    to = attrs.get("dtype")
    as_int = int(to) in (6, 7) if to is not None \
        else isinstance(x, (ITensor, DITensor))
    if as_int:
        return [ITensor(eye.astype(np.int64))]
    return [_host_float(eye)]


def _nonzero(inputs, attrs):
    x = inputs[0]
    if not isinstance(x, ITensor):
        raise ValueError(
            "NonZero needs host-resident (shape-domain) data: its output "
            "shape is data-dependent, which a static-shape forward cannot "
            "carry")
    return [ITensor(np.stack(np.nonzero(np.asarray(x.data)), 0)
                    .astype(np.int64))]


def _compress(inputs, attrs):
    x, cond = inputs[0], inputs[1]
    if not isinstance(cond, ITensor):
        raise ValueError(
            "Compress condition must be host-resident: the output shape "
            "is data-dependent otherwise")
    keep = np.flatnonzero(np.asarray(cond.data) != 0)
    axis = attrs.get("axis")
    if isinstance(x, ITensor):
        d = np.asarray(x.data)
        y = d.reshape(-1)[keep] if axis is None \
            else np.take(d, keep, axis=int(axis))
        return [ITensor(y.astype(np.int64))]
    d = x.data
    idx = place(keep, d.device, torch.int64)
    y = torch.index_select(d.reshape(-1), 0, idx) if axis is None \
        else torch.index_select(d, int(axis) % d.ndim, idx)
    return [FTensor(y)]


def _unique(inputs, attrs):
    x = inputs[0]
    if not isinstance(x, ITensor):
        raise ValueError(
            "Unique needs host-resident data: every output shape is "
            "data-dependent")
    axis = attrs.get("axis")
    d = np.asarray(x.data)
    flat = d if axis is not None else d.reshape(-1)
    y, first, inverse, counts = np.unique(
        flat, axis=None if axis is None else int(axis),
        return_index=True, return_inverse=True, return_counts=True)
    if not int(attrs.get("sorted", 1)):
        # first-occurrence order
        order = np.argsort(first, kind="stable")
        y = y[order] if axis is None else np.take(y, order, axis=int(axis))
        remap = np.empty_like(order)
        remap[order] = np.arange(order.size)
        first, counts = first[order], counts[order]
        inverse = remap[inverse]
    return [ITensor(np.asarray(y, np.int64)),
            ITensor(first.astype(np.int64)),
            ITensor(inverse.reshape(-1).astype(np.int64)),
            ITensor(counts.astype(np.int64))]


def _bit_shift(inputs, attrs):
    a, b = inputs[0], inputs[1]
    left = _str(attrs, "direction", "LEFT") == "LEFT"
    if isinstance(a, ITensor) and isinstance(b, ITensor):
        y = np.left_shift(a.data, b.data) if left \
            else np.right_shift(a.data, b.data)
        return [ITensor(np.asarray(y, np.int64))]
    fn = torch.bitwise_left_shift if left else torch.bitwise_right_shift
    return [DITensor(fn(_dev(a), _dev(b)))]


_BITWISE = {"BitwiseAnd": (np.bitwise_and, torch.bitwise_and),
            "BitwiseOr": (np.bitwise_or, torch.bitwise_or),
            "BitwiseXor": (np.bitwise_xor, torch.bitwise_xor)}


def _bitwise(op, inputs, attrs):
    a, b = inputs[0], inputs[1]
    np_fn, torch_fn = _BITWISE[op]
    if isinstance(a, ITensor) and isinstance(b, ITensor):
        return [ITensor(np.asarray(np_fn(a.data, b.data), np.int64))]
    return [DITensor(torch_fn(_dev(a), _dev(b)))]


def _bitwise_not(inputs, attrs):
    x = inputs[0]
    if isinstance(x, ITensor):
        return [ITensor(np.asarray(np.invert(x.data), np.int64))]
    return [DITensor(torch.bitwise_not(_dev(x)))]


def _lp_norm(inputs, attrs):
    x = inputs[0].data
    axis = int(attrs.get("axis", -1))
    p = int(attrs.get("p", 2))
    if p == 1:
        norm = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    elif p == 2:
        norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        raise ValueError(f"LpNormalization p={p} not in (1, 2)")
    return [FTensor(x / norm)]


def _reverse_sequence(inputs, attrs):
    x, lens = inputs[0], inputs[1]
    batch_axis = int(attrs.get("batch_axis", 1))
    time_axis = int(attrs.get("time_axis", 0))
    if not isinstance(lens, ITensor):
        raise ValueError("ReverseSequence sequence_lens must be "
                         "host-resident (it drives a static gather)")
    ln = np.asarray(lens.data, np.int64)
    t_len = int(x.shape.data[time_axis])
    t = np.arange(t_len)[None, :]
    # per-row time index: reversed inside the first len_b steps
    idx = np.where(t < ln[:, None], ln[:, None] - 1 - t, t)  # [B, T]
    shape = [1] * len(np.asarray(x.shape.data))
    shape[batch_axis] = idx.shape[0]
    shape[time_axis] = t_len
    full = np.broadcast_to(idx.reshape(shape) if batch_axis < time_axis
                           else idx.T.reshape(shape), tuple(x.data.shape))
    if isinstance(x, ITensor):
        return [ITensor(np.take_along_axis(np.asarray(x.data), full,
                                           axis=time_axis))]
    d = x.data
    return [FTensor(torch.gather(d, time_axis,
                                 place(full, d.device, torch.int64)))]


def _tile(inputs, attrs):
    x, rep = inputs[0], inputs[1]
    reps = tuple(int(r) for r in np.asarray(rep.data).reshape(-1))
    if isinstance(x, ITensor):
        return [ITensor(np.tile(x.data, reps))]
    cls = DITensor if isinstance(x, DITensor) else FTensor
    return [cls(torch.tile(x.data, reps))]


def _range(inputs, attrs):
    def host_scalar(t):
        if isinstance(t, ITensor):
            return int(np.asarray(t.data).reshape(-1)[0])
        host = getattr(t, "host", None)  # a float constant's host copy
        if host is not None:
            return float(np.asarray(host).reshape(-1)[0])
        raise ValueError("Range start/limit/delta must be graph constants "
                         "(static shapes)")
    start, limit, delta = (host_scalar(t) for t in inputs[:3])
    if all(isinstance(t, ITensor) for t in inputs[:3]):
        return [ITensor(np.arange(start, limit, delta, dtype=np.int64))]
    return [_host_float(np.arange(start, limit, delta, dtype=np.float32))]


def _cumsum(inputs, attrs):
    x = inputs[0]
    axis = int(np.asarray(inputs[1].data).reshape(-1)[0])
    exclusive = int(attrs.get("exclusive", 0))
    reverse = int(attrs.get("reverse", 0))
    d = x.data
    if isinstance(x, ITensor):
        if reverse:
            d = np.flip(d, axis)
        c = np.cumsum(d, axis=axis)
        if exclusive:
            c = c - d
        return [ITensor(np.flip(c, axis) if reverse else c)]
    if reverse:
        d = torch.flip(d, (axis,))
    c = torch.cumsum(d, dim=axis)
    if exclusive:
        c = c - d
    if reverse:
        c = torch.flip(c, (axis,))
    return [DITensor(c) if isinstance(x, DITensor) else FTensor(c)]


def _trilu(inputs, attrs):
    x = inputs[0]
    k = int(np.asarray(inputs[1].data).reshape(-1)[0]) \
        if _opt(inputs, 1) is not None else 0
    upper = int(attrs.get("upper", 1))
    if isinstance(x, ITensor):
        return [ITensor((np.triu if upper else np.tril)(x.data, k))]
    d = (torch.triu if upper else torch.tril)(x.data, k)
    return [DITensor(d) if isinstance(x, DITensor) else FTensor(d)]


def _one_hot(inputs, attrs):
    idx, depth, values = inputs[0], inputs[1], inputs[2]
    axis = int(attrs.get("axis", -1))
    n = int(np.asarray(depth.data).reshape(-1)[0])
    host = isinstance(idx, ITensor)
    if host:
        ids = np.asarray(idx.data)
        ids = np.where(ids < 0, ids + n, ids)  # negative wraps
        mask = ids[..., None] == np.arange(n)
        if axis != -1 and axis != mask.ndim - 1:
            mask = np.moveaxis(mask, -1, axis % mask.ndim)
    else:
        ids = idx.data
        ids = torch.where(ids < 0, ids + n, ids)
        mask = ids[..., None] == torch.arange(n, device=ids.device)
        if axis != -1 and axis != mask.ndim - 1:
            mask = torch.movedim(mask, -1, axis % mask.ndim)
    if isinstance(values, FTensor):
        vals = values.data
        m = place(mask, vals.device, torch.bool) if host \
            else mask.to(vals.device)
        return [FTensor(torch.where(m, vals[1], vals[0]))]
    vals = np.asarray(values.data)
    if host:
        return [ITensor(np.where(mask, int(vals[1]), int(vals[0])))]
    return [DITensor(torch.where(mask, int(vals[1]), int(vals[0]))
                     .to(torch.int32))]


def _einsum(inputs, attrs):
    eq = _str(attrs, "equation", "")
    return [FTensor(torch.einsum(eq, *[t.data for t in inputs]))]


def _min_max(op, inputs, attrs):
    if isinstance(inputs[0], ITensor):
        fn = np.minimum if op == "Min" else np.maximum
        y = inputs[0].data
        for t in inputs[1:]:
            y = fn(y, t.data)
        return [ITensor(y)]
    fn = torch.minimum if op == "Min" else torch.maximum
    y = inputs[0].data
    for t in inputs[1:]:
        y = fn(y, t.data)
    return [FTensor(y)]


def conv1d_op(inputs, attrs):
    """1-D Conv always runs in float (JAX's rule); quantized operands
    dequantize here."""
    x, w = inputs[0], inputs[1]
    b = inputs[2] if len(inputs) > 2 else None
    x, w, b = (t.dequantize() if isinstance(t, QTensor) else t
               for t in (x, w, b))
    return [FTensor(conv1d_ncl(
        x.data, w.data.to(x.data.dtype),
        None if b is None else b.data.to(x.data.dtype),
        tuple(attrs.get("pads", (0, 0))), tuple(attrs.get("strides", (1,))),
        tuple(attrs.get("dilations", (1,))), int(attrs.get("group", 1))))]


def _f(fn):
    """An activation over the float data: ``fn(x, attrs)``."""
    return lambda inputs, attrs: [FTensor(fn(inputs[0].data, attrs))]


def _alpha(attrs, default):
    return float(np.float32(attrs.get("alpha", default)))


OPS = {
    "Sub": lambda i, a: [i[0] + (-i[1])],
    "Flatten": _flatten,
    "Squeeze": _squeeze,
    "Pow": _pow,
    "Abs": _unary_host_or_float(np.abs, torch.abs),
    "Clip": _clip,
    "ReduceSum": _reduce_sum,
    "ReduceMax": lambda i, a: _reduce_min_max("ReduceMax", i, a),
    "ReduceMin": lambda i, a: _reduce_min_max("ReduceMin", i, a),
    "ArgMax": lambda i, a: _arg_reduce("ArgMax", i, a),
    "ArgMin": lambda i, a: _arg_reduce("ArgMin", i, a),
    "TopK": _topk,
    "Min": lambda i, a: _min_max("Min", i, a),
    "Max": lambda i, a: _min_max("Max", i, a),
    "Pad": _pad,
    "Resize": lambda i, a: [resize(i, a)],
    "ScatterElements": scatter_elements,
    "GatherElements": gather_elements,
    "Gelu": _gelu,
    "LeakyRelu": _f(lambda x, a: torch.where(x >= 0, x,
                                             _alpha(a, 0.01) * x)),
    "Elu": _f(lambda x, a: torch.where(
        x >= 0, x, _alpha(a, 1.0) * (torch.exp(x) - 1.0))),
    "Selu": _f(lambda x, a: float(np.float32(a.get(
        "gamma", 1.05070102214813232421875))) * torch.where(
        x > 0, x, float(np.float32(a.get("alpha", 1.67326319217681884765625)))
        * (torch.exp(x) - 1.0))),
    "Softplus": _f(lambda x, a: _logaddexp0(x)),
    "Softsign": _f(lambda x, a: x / (1.0 + torch.abs(x))),
    "HardSigmoid": _f(lambda x, a: torch.clamp(
        _alpha(a, 0.2) * x + float(np.float32(a.get("beta", 0.5))),
        0.0, 1.0)),
    "HardSwish": _f(lambda x, a: x * torch.clamp(
        x * float(np.float32(1 / 6)) + 0.5, 0.0, 1.0)),
    "Mish": _f(lambda x, a: x * torch.tanh(_logaddexp0(x))),
    "PRelu": lambda i, a: [FTensor(torch.where(i[0].data >= 0, i[0].data,
                                               i[1].data * i[0].data))],
    "BatchNormalization": _batch_norm,
    "ConvTranspose": _conv_transpose,
    "GroupNormalization": _group_norm,
    "InstanceNormalization": _instance_norm,
    "GlobalAveragePool": lambda i, a: [FTensor(torch.mean(
        i[0].data, dim=(2, 3), keepdim=True))],
    "MaxPool": lambda i, a: _pool("MaxPool", i, a),
    "AveragePool": lambda i, a: _pool("AveragePool", i, a),
    "Tile": _tile,
    "Range": _range,
    "CumSum": _cumsum,
    "Trilu": _trilu,
    "OneHot": _one_hot,
    "Einsum": _einsum,
    "Round": lambda i, a: [FTensor(torch.round(i[0].data))],
    "Sign": _sign,
    "Mod": _mod,
    "Greater": lambda i, a: _compare("Greater", i, a),
    "Less": lambda i, a: _compare("Less", i, a),
    "GreaterOrEqual": lambda i, a: _compare("GreaterOrEqual", i, a),
    "LessOrEqual": lambda i, a: _compare("LessOrEqual", i, a),
    "Not": _not,
    "And": lambda i, a: _logical("And", i, a),
    "Or": lambda i, a: _logical("Or", i, a),
    "Xor": lambda i, a: _logical("Xor", i, a),
    "IsNaN": lambda i, a: _is_nan_inf("IsNaN", i, a),
    "IsInf": lambda i, a: _is_nan_inf("IsInf", i, a),
    "LogSoftmax": _log_softmax,
    "GatherND": _gather_nd_op,
    "ScatterND": scatter_nd,
    "DepthToSpace": lambda i, a: _depth_space("DepthToSpace", i, a),
    "SpaceToDepth": lambda i, a: _depth_space("SpaceToDepth", i, a),
    "Sum": lambda i, a: _sum_mean("Sum", i, a),
    "Mean": lambda i, a: _sum_mean("Mean", i, a),
    "GlobalMaxPool": lambda i, a: [FTensor(torch.amax(
        i[0].data, dim=tuple(range(2, i[0].data.ndim)), keepdim=True))],
    "Hardmax": _hardmax,
    "Shrink": _shrink,
    "ThresholdedRelu": _f(lambda x, a: torch.where(
        x > _alpha(a, 1.0), x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))),
    "Celu": _celu,
    "EyeLike": _eye_like,
    "NonZero": _nonzero,
    "Compress": _compress,
    "Unique": _unique,
    "BitShift": _bit_shift,
    "BitwiseAnd": lambda i, a: _bitwise("BitwiseAnd", i, a),
    "BitwiseOr": lambda i, a: _bitwise("BitwiseOr", i, a),
    "BitwiseXor": lambda i, a: _bitwise("BitwiseXor", i, a),
    "BitwiseNot": _bitwise_not,
    "LpNormalization": _lp_norm,
    "ReverseSequence": _reverse_sequence,
}
for _op in ("ReduceProd", "ReduceL1", "ReduceL2", "ReduceSumSquare",
            "ReduceLogSum", "ReduceLogSumExp"):
    OPS[_op] = (lambda op: lambda i, a: _reduce_extra(op, i, a))(_op)
for _op, _fn in UNARY_FLOAT_FNS.items():
    OPS[_op] = (lambda fn: lambda i, a: [FTensor(fn(i[0].data))])(_fn)
