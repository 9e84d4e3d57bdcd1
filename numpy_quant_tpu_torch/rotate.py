"""QuaRot-style orthogonal rotation of the attention V/O pair (Ashkboos
et al., arXiv:2404.00456, the R2 rotation); port of
``numpy_quant_tpu/rotate.py``.

Per attention head, context = probs @ V feeds the output projection
linearly, so an orthogonal ``R`` [D, D] between them is an exact
reparameterization for any probabilities:

    V' = V R,   W_o' = R^T W_o    =>    probs V' W_o' = probs V W_o

A random orthogonal R spreads outlier directions of the V channels over
all D lanes, which per-tensor quantization of the v/o weights needs.
Data-free and weights-only. The pass matches the builders' attention
idiom on the float graph: Softmax -> MatMul(probs, vh) -> Transpose ->
Reshape -> MatMul(W_o), vh from Transpose(Reshape(v projection)) of a
dedicated v Linear (ViT, T5) or the v third of a merged-QKV Split (GPT-2).
Chains with extra consumers, GQA ``repeat_kv`` or decode-step cache
inputs stay untouched. R is drawn on the host with numpy from the seed,
the JAX package's draw, and the weights are rewritten on the host in
float32 as there, so both packages produce the same constants.
"""
from __future__ import annotations

import numpy as np

from .graph import Constant
from .passes.weights import float_array, set_float
from .tensor import FTensor


def _single_consumer(value, op: str):
    """The value's one consumer node when it has exactly one and it is
    ``op``, else None."""
    if len(value.outputs) != 1 or value.outputs[0].op != op:
        return None
    return value.outputs[0]


def _producer(value, op: str):
    ins = getattr(value, "inputs", None)
    if not ins or len(ins) != 1 or ins[0].op != op:
        return None
    return ins[0]


def _const_array(value):
    """The static ndarray behind a value: an initializer Constant's
    data, or the ``value`` attr of a producing Constant op node."""
    if isinstance(value, Constant):
        data = value.data.data
        return float_array(value) if isinstance(value.data, FTensor) \
            else np.asarray(data)
    prod = _producer(value, "Constant")
    if prod is not None:
        v = prod.attrs.get("value")
        if v is not None:
            return np.asarray(v)
    return None


def _head_dims(reshape_node):
    """(n_heads, head_dim) from a head-split Reshape's target shape:
    a constant tail [..., H, D] or a Concat(batch, [-1, H, D])."""
    shape_val = reshape_node.inputs[1]
    arr = _const_array(shape_val)
    if arr is None:
        prod = _producer(shape_val, "Concat")
        if prod is None:
            return None
        arr = _const_array(prod.inputs[-1])
    if arr is None or arr.ndim != 1 or arr.size < 2:
        return None
    return int(arr[-2]), int(arr[-1])


def _const_2d(value):
    if isinstance(value, Constant) and isinstance(value.data, FTensor) \
            and value.data.data.ndim == 2:
        return float_array(value)
    return None


def _match_v_projection(v_val):
    """Trace a head-split v value back to its weight constant. Returns
    (weight_const, bias_const_or_None, col_slice) where ``col_slice``
    selects the v columns inside the weight (the whole width for a
    dedicated Linear, the last third for a merged-QKV Split)."""
    node = v_val.inputs[0] if getattr(v_val, "inputs", None) else None
    if node is None:
        return None
    bias = None
    if node.op == "Add":
        b = node.inputs[1]
        if not isinstance(b, Constant) or not isinstance(b.data, FTensor):
            return None
        bias = b
        mm_val = node.inputs[0]
        if len(mm_val.outputs) != 1:
            return None
        node = mm_val.inputs[0] if getattr(mm_val, "inputs", None) else None
        if node is None:
            return None
    if node.op == "MatMul":
        w = _const_2d(node.inputs[1])
        if w is None or len(node.inputs[1].outputs) != 1:
            return None
        return node.inputs[1], bias, slice(0, w.shape[1])
    if node.op == "Split":
        # merged QKV (GPT-2): v is the last of three equal outputs
        if len(node.outputs) != 3 or v_val is not node.outputs[2]:
            return None
        if int(node.attrs.get("axis", 0)) != -1:
            return None
        src = node.inputs[0]
        prod = _producer(src, "Add")
        if prod is None or len(src.outputs) != 1:
            return None
        b = prod.inputs[1]
        if not isinstance(b, Constant) or not isinstance(b.data, FTensor):
            return None
        mm_val = prod.inputs[0]
        if len(mm_val.outputs) != 1:
            return None
        mm = mm_val.inputs[0] if getattr(mm_val, "inputs", None) else None
        if mm is None or mm.op != "MatMul":
            return None
        w = _const_2d(mm.inputs[1])
        if w is None or len(mm.inputs[1].outputs) != 1 \
                or w.shape[1] % 3:
            return None
        third = w.shape[1] // 3
        return mm.inputs[1], b, slice(2 * third, 3 * third)
    return None


def _rotation(d: int, rng) -> np.ndarray:
    """A maximally-incoherent orthogonal [d, d]: a sign-randomized
    Hadamard (every entry exactly 1/sqrt(d) -- the QuaRot choice, which
    guarantees the absmax of a rotated outlier shrinks ~sqrt(d)) when d
    is a power of two, else QR of a gaussian."""
    if d & (d - 1) == 0:
        H = np.ones((1, 1), np.float64)
        while H.shape[0] < d:
            H = np.block([[H, H], [H, -H]])
        s = rng.choice([-1.0, 1.0], size=d)
        return ((H * s[None, :]) / np.sqrt(d)).astype(np.float32)
    return np.linalg.qr(
        rng.normal(size=(d, d)))[0].astype(np.float32)


def rotate_vo(model, seed: int = 0) -> int:
    """Rotate every matched attention's V projection and output
    projection by a shared random orthogonal ``R`` per head (QR of a
    seeded gaussian). Mutates the float model in place; returns the
    number of attentions rotated. Run before ``quantize`` /
    ``quantize_weights`` (per-tensor weight modes benefit most)."""
    rng = np.random.default_rng(seed)
    rotated = 0
    for s_node in model.nodes:
        if s_node.op != "Softmax":
            continue
        ctx = _single_consumer(s_node.outputs[0], "MatMul")
        if ctx is None or ctx.inputs[0] is not s_node.outputs[0]:
            continue
        vh_val = ctx.inputs[1]
        # vh: Transpose(perm 0213) <- Reshape <- v-projection
        vh_t = _producer(vh_val, "Transpose")
        if vh_t is None or len(vh_val.outputs) != 1 \
                or list(vh_t.attrs.get("perm", [])) != [0, 2, 1, 3]:
            continue
        vh_r_val = vh_t.inputs[0]
        vh_r = _producer(vh_r_val, "Reshape")
        if vh_r is None or len(vh_r_val.outputs) != 1:
            continue
        dims = _head_dims(vh_r)
        if dims is None:
            continue
        n_heads, head_dim = dims
        v_val = vh_r.inputs[0]
        if len(v_val.outputs) != 1:
            continue
        vm = _match_v_projection(v_val)
        if vm is None:
            continue
        w_v, b_v, cols = vm

        # ctx -> Transpose(0213) -> Reshape(merge) -> MatMul(W_o)
        ctx_t = _single_consumer(ctx.outputs[0], "Transpose")
        if ctx_t is None \
                or list(ctx_t.attrs.get("perm", [])) != [0, 2, 1, 3]:
            continue
        merge = _single_consumer(ctx_t.outputs[0], "Reshape")
        if merge is None:
            continue
        o_node = _single_consumer(merge.outputs[0], "MatMul")
        if o_node is None or o_node.inputs[0] is not merge.outputs[0]:
            continue
        w_o_arr = _const_2d(o_node.inputs[1])
        if w_o_arr is None or len(o_node.inputs[1].outputs) != 1 \
                or w_o_arr.shape[0] != n_heads * head_dim:
            continue
        wv_arr = float_array(w_v)
        if (cols.stop - cols.start) != n_heads * head_dim:
            continue

        R = _rotation(head_dim, rng)

        blk = wv_arr[:, cols].reshape(-1, n_heads, head_dim)
        wv_arr = wv_arr.copy()
        wv_arr[:, cols] = (blk @ R).reshape(-1, n_heads * head_dim)
        set_float(w_v, wv_arr)
        if b_v is not None:
            bv = float_array(b_v).copy()
            bb = bv[cols].reshape(n_heads, head_dim)
            bv[cols] = (bb @ R).reshape(-1)
            set_float(b_v, bv)
        wo3 = np.asarray(w_o_arr, np.float32).reshape(
            n_heads, head_dim, -1)
        set_float(o_node.inputs[1], np.einsum("de,hen->hdn", R.T, wo3)
                  .reshape(n_heads * head_dim, -1).astype(np.float32))
        rotated += 1

    if rotated:
        model.invalidate_params()
    return rotated
