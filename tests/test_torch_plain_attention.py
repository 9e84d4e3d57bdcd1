"""The port's pre-split fused attention and the LLaMA ops around it, held
against the JAX package in TPU-mode numerics (x64 off):

* ``fused_attention_reference`` (the plain version of
  ``csrc/attention_plain.cu``) against JAX's ``fused_attention`` in
  interpret mode on seeded int8 inputs, at N=50 (JAX pads keys to 128
  lanes and the head dim to 128) and N=1024 (its blockwise 256-row grid):
  zero points zero and nonzero, no mask, causal and sliding window,
  out_requant off and on. Bit equality at N=50; at N=1024 rows of 1024
  probabilities sum in another order than XLA's, so a probability may
  round one step apart: at most 0.1% of the rows, each by one step
  (255*sp*sv, or that over the requant scale, rounded, on int8 out), the
  count printed;
* the ``FusedAttention`` registry op against JAX's, and the fusion pass's
  plain branch and pre-scaled failure against JAX's reports;
* the registry ops ReduceMean, Sqrt, Neg and Sigmoid against JAX's: Neg bit
  for bit, Sqrt and Sigmoid within 2 ulp (XLA's CPU sqrt and exp are not
  torch's: its sqrt is one ulp off the correctly rounded root on ~1% of
  inputs), ReduceMean within 2 ulp of the largest |input| (sums in other
  orders);
* the same ops and the FusedAttention op in the bf16 serving mode against
  JAX's bf16 mode: Neg and the attention output bit for bit, the rest
  within one bf16 ulp;
* the executor's liveness: a QModel's outputs are the same with values
  freed after their last use and kept (``record=True``), and
  ``calibration_stats`` folds to the same dict as min/max over every
  value of a kept walk.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.kernels.attention import fused_attention as jax_fa
from numpy_quant_tpu.ops.registry import onnx_operator_implementation as j_op
from numpy_quant_tpu.tensor import FTensor as JFTensor
from numpy_quant_tpu.tensor import ITensor as JITensor
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.graph import Constant
from numpy_quant_tpu_torch.kernels import attention as TA
from numpy_quant_tpu_torch.models import gpt as TG
from numpy_quant_tpu_torch.onnx.builder import GraphBuilder
from numpy_quant_tpu_torch.ops.registry import onnx_operator_implementation
from numpy_quant_tpu_torch.tensor import FTensor, ITensor, QTensor

# calibrated-looking (not round) scales: round ones put many requant
# results exactly on rounding ties
QP = dict(scaling=0.35, sq=0.0213, zq=3, sk=0.0311, zk=-2, sv=0.0517,
          zv=4, sp=float(np.float32(1.0 / 255.0)), zp_p=-128, bit_width=8)
QP_ZERO = dict(QP, zq=0, zk=0, zv=0, zp_p=0,
               sp=float(np.float32(1.0 / 127.0)))
OUT_REQUANT = (0.0213, 4)
MASK = float(np.float32(-3.2e8))  # a dequantized -1e9-style mask value
MASKS = {"none": (None, None), "causal": (MASK, None), "window": (MASK, 6)}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _inputs(bh, n, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.integers(-100, 100, size=(bh, n, d)).astype(np.int8)
               for _ in range(3))
    return q, np.ascontiguousarray(k.transpose(0, 2, 1)), v


def _kw(zp, mask, out_requant):
    m, w = MASKS[mask]
    return dict(QP if zp == "nonzero" else QP_ZERO, out_requant=out_requant,
                causal_mask_val=m, causal_window=w)


@pytest.mark.parametrize("out_requant", [None, OUT_REQUANT])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("zp", ["nonzero", "zero"])
@pytest.mark.parametrize("n", [50, 1024])
def test_plain_version_matches_jax(n, zp, mask, out_requant):
    q, kt, v = _inputs(3 if n == 50 else 2, n, 16, seed=n + len(mask))
    kw = _kw(zp, mask, out_requant)
    want = np.asarray(jax_fa(jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v),
                             interpret=True, **kw))
    got = TA.fused_attention(torch.from_numpy(q), torch.from_numpy(kt),
                             torch.from_numpy(v), **kw).numpy()
    assert got.shape == want.shape == q.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.float64)).max() > 0
    if n == 50:
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    rows = diff.max(axis=-1)
    flips = int((rows > 0).sum())
    print(f"N={n} {zp} {mask} rq={out_requant}: rows differing {flips} of "
          f"{rows.size}")
    step = 255.0 * kw["sp"] * kw["sv"] * (1 + 1e-6)
    if out_requant is not None:
        step = float(int(step / out_requant[0]) + 1)
    assert diff.max() <= step
    assert flips <= 0.001 * rows.size


def test_blockwise_tiles_change_no_bit():
    """Rows are independent: the plain version in 8-row tiles, in JAX's
    256-row tiles (the default at N >= 1024) and in one tile agree."""
    q, kt, v = (torch.from_numpy(a) for a in _inputs(2, 1024, 16, seed=9))
    for zp, mask in itertools.product(("nonzero", "zero"), MASKS):
        kw = _kw(zp, mask, None)
        whole = TA.fused_attention_reference(q, kt, v, block_q=1024, **kw)
        for bq in (8, None):
            np.testing.assert_array_equal(
                TA.fused_attention_reference(q, kt, v, block_q=bq,
                                             **kw).numpy(), whole.numpy())


def test_wrapper_takes_plain_version_on_cpu_and_checks_operands():
    q, kt, v = (torch.from_numpy(a) for a in _inputs(2, 50, 16, seed=1))
    kw = _kw("nonzero", "causal", OUT_REQUANT)
    before = TA.fused_attention.launches
    out = TA.fused_attention(q, kt, v, **kw)
    assert TA.fused_attention.launches == before
    np.testing.assert_array_equal(
        out.numpy(), TA.fused_attention_reference(q, kt, v, **kw).numpy())
    with pytest.raises(ValueError, match="BH, D, N"):
        TA.fused_attention(q, kt.transpose(1, 2).contiguous(), v, **kw)
    with pytest.raises(TypeError, match="int8"):
        TA.fused_attention(q.to(torch.int32), kt, v, **kw)
    with pytest.raises(ValueError, match="rank-3"):
        TA.fused_attention(q[None], kt, v, **kw)


def _jq(arr, scale, zp):
    return JQTensor(jnp.asarray(arr.astype(np.int32)), 8, np.float32(scale),
                    None if zp is None else np.int64(zp))


def _tq(arr, scale, zp):
    return QTensor(torch.from_numpy(arr.astype(np.int32)), 8,
                   np.float32(scale), None if zp is None else np.int64(zp))


@pytest.mark.parametrize("out_requant", [None, OUT_REQUANT])
def test_registry_op_matches_jax(out_requant):
    """FusedAttention on [B, H, N, D] q, [B, H, D, N] k^T (a transposed
    view, as the graph hands it over) and v, with the pass's attributes."""
    b, h, n, d = 2, 3, 50, 16
    rng = np.random.default_rng(4)
    q, k, v = (rng.integers(-128, 128, size=(b, h, n, d)) for _ in range(3))
    kt = k.transpose(0, 1, 3, 2)
    attrs = dict(scaling=0.25, probs_scale=float(np.float32(1 / 255)),
                 probs_zero_point=-128, causal_mask_val=MASK)
    if out_requant is not None:
        attrs["out_requant"] = out_requant
    scales = ((0.0213, 3), (0.0311, -2), (0.0517, 4))
    want = j_op("FusedAttention",
                [_jq(a, *sz) for a, sz in zip((q, kt, v), scales)], attrs)[0]
    got = onnx_operator_implementation(
        "FusedAttention", [_tq(q, *scales[0]),
                           _tq(k, *scales[1]).transpose(0, 1, 3, 2),
                           _tq(v, *scales[2])], attrs)[0]
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    if out_requant is not None:
        assert np.float32(got.scale) == np.float32(want.scale)
        assert got.zero_point == want.zero_point


def _core_graph(scaled: bool):
    """q/k/v head inputs [1, 2, 8, 16] -> MatMul(q, k^T) -> [Mul] ->
    Softmax -> MatMul(v): no head-split chains around the core."""
    g = GraphBuilder("core")
    for name in ("q", "k", "v"):
        g.input(name, [1, 2, 8, 16])
    kt = g.node("Transpose", ["k"], out="k_T", perm=[0, 1, 3, 2])
    s = g.node("MatMul", ["q", kt], out="scores")
    if scaled:
        c = g.const(np.array(np.float32(0.25), dtype=np.float32), "scaling")
        s = g.node("Mul", [s, c], out="scaled")
    p = g.node("Softmax", [s], out="probs", axis=-1)
    g.node("MatMul", [p, "v"], out="ctx")
    g.output("ctx", [1, 2, 8, 16])
    return g.model()


@pytest.mark.parametrize("scaled", [True, False])
def test_plain_fusion_report_matches_jax(scaled):
    """With a scale node the core fuses plainly (FusedAttention, recorded
    in plain_fusions); pre-scaled scores record JAX's failure. Fused equals
    unfused bit for bit."""
    proto = _core_graph(scaled)
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(1, 2, 8, 16)).astype(np.float32) for _ in range(3)]
    jm = nq.Model.from_onnx(_jax_proto(scaled))
    stats = jm.calibration_stats(xs)
    jq = jm.quantize(bit_width=8, stats=stats)
    jrep = jq.optimize()
    tq = Model.from_onnx(proto, device="cpu").quantize(bit_width=8,
                                                       stats=stats)
    unfused = tq(xs)[0]
    trep = tq.optimize()
    assert trep["fuse_attention"] == jrep["fuse_attention"] == int(scaled)
    assert trep["fusion_failures"] == jrep["fusion_failures"]
    assert tq.fusion_report.get("plain_fusions") \
        == jq.fusion_report.get("plain_fusions")
    assert [n.op for n in tq.nodes if n.op.startswith("Fused")] \
        == (["FusedAttention"] if scaled else [])
    np.testing.assert_array_equal(tq(xs)[0], unfused)


def _jax_proto(scaled: bool):
    from numpy_quant_tpu.onnx.builder import GraphBuilder as JGraphBuilder
    g = JGraphBuilder("core")
    for name in ("q", "k", "v"):
        g.input(name, [1, 2, 8, 16])
    kt = g.node("Transpose", ["k"], out="k_T", perm=[0, 1, 3, 2])
    s = g.node("MatMul", ["q", kt], out="scores")
    if scaled:
        c = g.const(np.array(np.float32(0.25), dtype=np.float32), "scaling")
        s = g.node("Mul", [s, c], out="scaled")
    p = g.node("Softmax", [s], out="probs", axis=-1)
    g.node("MatMul", [p, "v"], out="ctx")
    g.output("ctx", [1, 2, 8, 16])
    return g.model()


# -- the LLaMA float ops -------------------------------------------------


def _float_pair(shape, seed, positive=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 3
    if positive:
        x = np.abs(x) + np.float32(1e-3)
    return JFTensor(jnp.asarray(x)), FTensor(torch.from_numpy(x))


@pytest.mark.parametrize("op,positive", [("Neg", False), ("Sqrt", True),
                                         ("Sigmoid", False)])
def test_unary_ops_match_jax(op, positive):
    jx, tx = _float_pair((3, 5, 64), seed=3, positive=positive)
    want = np.asarray(j_op(op, [jx], {})[0].data)
    got = onnx_operator_implementation(op, [tx], {})[0].data.numpy()
    assert got.dtype == want.dtype == np.float32
    if op == "Neg":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=2)


@pytest.mark.parametrize("form", ["attr", "input", "nokeep", "two_axes",
                                  "all"])
def test_reduce_mean_matches_jax(form):
    jx, tx = _float_pair((3, 5, 64), seed=6)
    attrs, extra_j, extra_t = {}, [], []
    if form == "attr":
        attrs = dict(axes=[-1], keepdims=1)
    elif form == "input":
        extra_j, extra_t = [JITensor(np.array([-1]))], [ITensor(np.array([-1]))]
    elif form == "nokeep":
        attrs = dict(axes=[1], keepdims=0)
    elif form == "two_axes":
        attrs = dict(axes=[0, 2], keepdims=1)
    want = np.asarray(j_op("ReduceMean", [jx] + extra_j, attrs)[0].data)
    got = onnx_operator_implementation("ReduceMean", [tx] + extra_t,
                                       attrs)[0].data.numpy()
    assert got.shape == want.shape
    # two sums in other orders: within 2 ulp of the largest |input|
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * eps * float(tx.data.abs().max()))


def _bf16_bits(t) -> np.ndarray:
    """The bfloat16 values of a torch or JAX array, as float32."""
    if isinstance(t, torch.Tensor):
        assert t.dtype == torch.bfloat16
        return t.float().numpy()
    assert t.dtype == jnp.bfloat16
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("op", ["Neg", "Sqrt", "Sigmoid", "ReduceMean",
                                "FusedAttention"])
def test_ops_in_bf16_mode_match_jax(op):
    """The bf16 serving mode runs the LLaMA float ops, and the FusedAttention
    op's f32 output, in bfloat16 as JAX's mode does: Neg and the attention
    output bit for bit, the rest within one bf16 ulp."""
    from numpy_quant_tpu import config as jconfig
    from numpy_quant_tpu_torch import config as tconfig
    if op == "FusedAttention":
        rng = np.random.default_rng(5)
        q, k, v = (rng.integers(-128, 128, size=(1, 2, 50, 16)) for _ in range(3))
        kt = k.transpose(0, 1, 3, 2)
        scales = ((0.0213, 3), (0.0311, -2), (0.0517, 4))
        attrs = dict(scaling=0.25, probs_scale=float(np.float32(1 / 255)),
                     probs_zero_point=-128, causal_mask_val=MASK)
        j_in = [_jq(a, *sz) for a, sz in zip((q, kt, v), scales)]
        t_in = [_tq(q, *scales[0]), _tq(k, *scales[1]).transpose(0, 1, 3, 2),
                _tq(v, *scales[2])]
    else:
        jx, tx = _float_pair((3, 5, 64), seed=7, positive=op == "Sqrt")
        attrs = dict(axes=[-1], keepdims=1) if op == "ReduceMean" else {}
        j_in, t_in = [jx], [tx]
    with jconfig.low_precision_floats(), tconfig.low_precision_floats():
        # inputs enter the mode as the executor's values do: as bf16
        if op != "FusedAttention":
            j_in = [JFTensor(j_in[0].data)]
            t_in = [FTensor(t_in[0].data)]
        want = _bf16_bits(j_op(op, j_in, attrs)[0].data)
        got = _bf16_bits(onnx_operator_implementation(op, t_in, attrs)[0].data)
    assert got.shape == want.shape
    if op in ("Neg", "FusedAttention"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                   atol=2.0 ** -8 * float(np.abs(want).max())
                                   if op == "ReduceMean" else 0)


# -- the executor's liveness ---------------------------------------------

GPT_CFG = dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=2, n_head=2)


@pytest.fixture(scope="module")
def gpt_qmodel():
    w = TG.random_gpt2_weights(GPT_CFG, seed=0)
    proto = TG.gpt_causal_lm(w, GPT_CFG, batch_size=2, seq_len=16)
    rng = np.random.default_rng(0)
    x = proto._wte[rng.integers(0, 96, size=(2, 16))]
    tm = Model.from_onnx(proto, device="cpu")
    return tm, tm.quantize(bit_width=8, stats=tm.calibration_stats([x])), x


def _stats_of_kept_walk(model, x):
    """min/max over every value of one walk that keeps them all (the
    calibration of a walk without liveness)."""
    data = model._forward({v.name: model._wrap_input(a, v)
                           for a, v in zip([x], model.inputs)}, record=True)
    out = {}
    for name, t in data.items():
        if isinstance(t, ITensor):
            out[name] = (np.float32(t.data.min()), np.float32(t.data.max()))
        else:
            d = t.data.to(torch.float32)
            out[name] = (np.float32(d.min().item()), np.float32(d.max().item()))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_freeing_changes_no_output(gpt_qmodel, fused):
    """Outputs with values freed after their last use equal those of a
    walk that keeps every value; the freed walk returns only the outputs
    among its intermediates, the kept one stores every value."""
    _, tq, x = gpt_qmodel
    if fused:
        tq.optimize()
    freed = tq([x])[0]
    kept = tq([x], record=True)[0]
    np.testing.assert_array_equal(freed, kept)
    made = [o for n in tq.nodes for o in n.outputs]
    assert all(o.data is not None for o in made)
    live = tq._forward({tq.inputs[0].name: tq._wrap_input(x, tq.inputs[0])})
    assert {o.name for o in made} & set(live) == {"logits"}
    for o in made:
        o.data = None


def test_calibration_stats_fold_as_values_are_made(gpt_qmodel):
    tm, _, x = gpt_qmodel
    got = tm.calibration_stats([x])
    want = _stats_of_kept_walk(tm, x)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
        assert all(isinstance(v, np.float32) for v in got[name])
    for v in tm.values:
        v.data = None if not isinstance(v, Constant) else v.data


def test_torch_order_replay_tells_the_trees_apart():
    """The host replay of torch's CUDA row-sum order (the kernel's order,
    which ``chip_smoke.py`` phase 10 requires torch's sum on the card to
    take) is a float32 summation of every element, within N ulp of the
    exact sum, and differs from the other lane tree (offsets 1..16) and
    from a sequential sum on enough of the probe's rows that the probe
    tells those orders apart."""
    x = np.random.default_rng(0).random((64, 1024), dtype=np.float32)
    exact = x.astype(np.float64).sum(axis=1)
    got = TA.torch_order_sum(x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, exact, rtol=1024 * 2.0 ** -24)
    part = np.zeros((64, 128), np.float32)
    for k in range(0, 1024, 128):
        part += x[:, k:k + 128]
    lanes = part.reshape(64, 32, 4)
    v = ((lanes[..., 0] + lanes[..., 1]) + lanes[..., 2]) + lanes[..., 3]
    while v.shape[1] > 1:
        v = v[:, 0::2] + v[:, 1::2]
    sequential = np.zeros(64, np.float32)
    for k in range(1024):
        sequential += x[:, k]
    for other in (v[:, 0], sequential):
        assert (got != other).sum() >= 8
    assert TA.torch_sums_in_kernel_order("cpu") in (False, True)
