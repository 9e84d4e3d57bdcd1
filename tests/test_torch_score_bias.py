"""The score-bias forms of the port's head-split attention held against the
JAX package in TPU-mode numerics (x64 off): the plain PyTorch versions of
the monolithic and blockwise kernels (numpy_quant_tpu_torch.kernels.
attention) with ``score_bias`` against the Pallas ``fused_attention_hs``
with its score-bias operand in interpret mode, the registry's broadcast of
the 4th FusedAttentionHS input, the blockwise dispatch's bias clause, and
the fusion pass's score-bias failures.

Tolerances: the exact forms are bit-equal to JAX's, the fast forms within
atol 2e-2 (JAX's own bound between its fast and exact kernels; the count of
differing outputs is printed). The blockwise plain version equals the
monolithic one bit for bit.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.kernels import attention as JA
from numpy_quant_tpu.onnx.builder import GraphBuilder as JGraphBuilder
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.graph import Constant
from numpy_quant_tpu_torch.kernels import attention as TA
from numpy_quant_tpu_torch.onnx.builder import GraphBuilder
from numpy_quant_tpu_torch.ops.registry import attention_call
from numpy_quant_tpu_torch.tensor import FTensor, QTensor

H, D = 2, 8
QP = dict(scaling=0.35, sq=0.0213, zq=3, sk=0.0311, zk=-2, sv=0.0517,
          zv=4, sp=float(np.float32(1.0 / 255.0)), zp_p=-128, bit_width=8)
QP_ZERO = dict(QP, zq=0, zk=0, zv=0, zp_p=0,
               sp=float(np.float32(1.0 / 127.0)))
OUT_REQUANT = (0.0213, 4)
SCORE_MAX = 3.17
MODES = {"exact": (False, None), "fast": (True, None),
         "fast_shift": (True, SCORE_MAX)}
# a dequantized finfo.min-style decoder constant above the diagonal
MASKED = float(np.float32(-3.2e8))


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _inputs(b, n, nq=None, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.integers(-100, 100, size=(b, n, H * D)).astype(np.int8)
               for _ in range(3))
    return q[:, :nq or n].copy(), k, v


def _bias(form: str, n: int, seed: int = 0) -> np.ndarray:
    """A graph-shaped bias constant: "2d" [N, N], "shared" [1, 1, N, N],
    "per_head" [1, H, N, N] (T5's relative bias), "decoder" [1, H, N, N]
    plus the masked value above the diagonal (T5's combined constant)."""
    rng = np.random.default_rng(seed)
    shape = {"2d": (n, n), "shared": (1, 1, n, n)}.get(form, (1, H, n, n))
    b = (rng.normal(size=shape) * 2.0).astype(np.float32)
    if form == "decoder":
        b = b + np.triu(np.full((n, n), MASKED, np.float32), k=1)
    return b.astype(np.float32)


def _heads_bias(form: str, n: int, seed: int = 0) -> torch.Tensor:
    """The [H, N, N] float32 operand the registry makes of ``_bias``."""
    qt = QTensor(torch.zeros(1, n, H * D, dtype=torch.int8), 8,
                 np.float32(0.1), None)
    bias = FTensor(torch.from_numpy(_bias(form, n, seed)))
    _, _, _, kw, _ = attention_call([qt, qt, qt, bias], dict(
        num_heads=H, scaling=1.0, probs_scale=QP["sp"], probs_zero_point=0))
    return kw["score_bias"]


def _kw(mode, qp, out_requant):
    fast, score_max = MODES[mode]
    return dict(qp, num_heads=H, fast=fast, score_max=score_max,
                out_requant=out_requant)


def _pair(q, k, v, bias, kw, block_q=None):
    """(JAX interpret-mode output, the port's plain output) on one input."""
    want = np.asarray(JA.fused_attention_hs(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bias.numpy()), block_q=block_q, interpret=True, **kw))
    got = TA.fused_attention_hs(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), score_bias=bias,
                                block_q=block_q, **kw).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    return want, got


def _hold(want, got, fast):
    diff = np.abs(want.astype(np.float64) - got.astype(np.float64))
    print(f"outputs differing: {int((diff > 0).sum())} of {diff.size}, "
          f"max {diff.max(initial=0.0):.3g}")
    if fast:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=0, atol=2e-2)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_requant", [None, OUT_REQUANT])
@pytest.mark.parametrize("zp", ["nonzero", "zero"])
@pytest.mark.parametrize("mode", list(MODES))
def test_monolithic_bias_matches_jax(mode, zp, out_requant):
    """The monolithic plain version with each bias form against JAX's
    monolithic kernel with its score-bias operand (N=20)."""
    n = 20
    assert not TA.blockwise(n, None, nq=n, bias_heads=H)
    q, k, v = _inputs(2, n, seed=3)
    kw = _kw(mode, QP if zp == "nonzero" else QP_ZERO, out_requant)
    for i, form in enumerate(("2d", "shared", "per_head", "decoder")):
        want, got = _pair(q, k, v, _heads_bias(form, n, seed=i), kw)
        _hold(want, got, MODES[mode][0])


@pytest.mark.parametrize("mode", list(MODES))
def test_blockwise_bias_matches_jax_grid(mode):
    """The blockwise plain version in block_q=8 tiles (the bias rows follow
    the q tiles) against JAX's block_q=8 grid at ragged N=50, each bias
    form, out_requant off and on, zero points zero and nonzero."""
    n = 50
    q, k, v = _inputs(2, n, seed=7)
    for (i, form), rq, qp in itertools.product(
            enumerate(("2d", "shared", "per_head", "decoder")),
            (None, OUT_REQUANT), (QP, QP_ZERO)):
        want, got = _pair(q, k, v, _heads_bias(form, n, seed=i),
                          _kw(mode, qp, rq), block_q=8)
        _hold(want, got, MODES[mode][0])


def test_blockwise_plain_equals_monolithic_plain():
    """Each row sees the same full-row reductions and its own bias rows in
    either plain version, so they agree bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 50, seed=11))
    bias = _heads_bias("decoder", 50, seed=4)
    for mode, rq in itertools.product(MODES, (None, OUT_REQUANT)):
        kw = dict(_kw(mode, QP, rq), score_bias=bias)
        np.testing.assert_array_equal(
            TA.fused_attention_hs_blockq_reference(q, k, v, block_q=16,
                                                   **kw).numpy(),
            TA.fused_attention_hs_reference(q, k, v, **kw).numpy())


def _jax_grid(n: int, heads: int) -> str:
    """Which grid JAX's wrapper takes for a biased call with ``n`` keys and
    ``heads`` heads: its blockwise entry is spied on while the call is
    traced (not run)."""
    calls = []
    real = JA._fused_attention_hs_blockq

    def spy(*a, **k):
        calls.append(n)
        return real(*a, **k)

    x = jnp.zeros((1, n, heads * D), jnp.int8)
    bias = jnp.zeros((heads, n, n), jnp.float32)
    # the wrapper's Python body, traced afresh (no jit cache in the way)
    wrapper = JA.fused_attention_hs.__wrapped__
    JA._fused_attention_hs_blockq = spy
    try:
        jax.make_jaxpr(lambda a, b: wrapper(
            a, a, a, b, num_heads=heads, interpret=True, **QP))(x, bias)
    finally:
        JA._fused_attention_hs_blockq = real
    return "blockwise" if calls else "monolithic"


@pytest.mark.parametrize("n,want", [(128, "monolithic"), (256, "monolithic"),
                                    (257, "blockwise"), (512, "blockwise")])
def test_bias_clause_answers_as_jax(n, want):
    """At t5-small's H=8 the bias clause H * round_up(nq, 8) *
    round_up(N, 128) * 4 > 2 MiB sends N=257 (264 rows x 384 lanes) and 512
    blockwise; N=256 is exactly 2 MiB and stays monolithic. The port
    decides as JAX's wrapper does, and without a bias every N here is
    monolithic."""
    got = "blockwise" if TA.blockwise(n, None, nq=n, bias_heads=8) \
        else "monolithic"
    assert got == want == _jax_grid(n, 8)
    assert not TA.blockwise(n, None, nq=n)


@pytest.mark.parametrize("heads", [1, 8, 12])
@pytest.mark.parametrize("d", TA.KERNEL_DIMS)
def test_biased_calls_pick_a_bias_instantiation_that_fits(d, heads):
    """Every biased call (nq == N) that the bias clause leaves on the
    monolithic kernel gets a plan within one block's shared memory in both
    softmax forms, and launches the instantiation with the bias compiled
    in; the same call without a bias takes the bias-free one."""
    for n in range(1, 897):
        mono = not TA.blockwise(n, None, nq=n, bias_heads=heads)
        if mono:
            for exact in (True, False):
                plan = TA.hs_plan(n, n, d, 8 * heads, exact=exact)
                assert plan["smem"] <= 232448
    for sm in TA.SOFTMAX_FORMS:
        assert TA.hs_form(d, True, sm) != TA.hs_form(d, False, sm)
        assert {TA.hs_form(d, b, sm) for b in (True, False)} \
            <= set(TA.HS_FORMS)


def test_bias_needs_every_query_row():
    """A bias indexes q rows by absolute position: narrow q with a bias
    raises (JAX asserts nq == N), as does a bias of the wrong shape."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 20, nq=1, seed=5))
    bias = _heads_bias("per_head", 20)
    for fn in (TA.fused_attention_hs, TA.fused_attention_hs_monolithic,
               TA.fused_attention_hs_blockq):
        with pytest.raises(ValueError, match="score bias needs all 20"):
            fn(q, k, v, score_bias=bias, **_kw("exact", QP, None))
    full = torch.from_numpy(_inputs(1, 20, seed=5)[0])
    with pytest.raises(ValueError, match="score_bias must be"):
        TA.fused_attention_hs(full, k, v, score_bias=bias[:1],
                              **_kw("exact", QP, None))


# -- the fusion pass's score-bias failures ---------------------------------


def _hs_graph(builder, bias: np.ndarray, split: bool, n: int = 8):
    """A pre-scaled attention chain with Add(scores, bias) before the
    Softmax: on [1, N, H*D] projections with the standard head split and
    merge (``split``), or on pre-split [1, H, N, D] heads."""
    g = builder("bias")
    if split:
        for name in ("xq", "xk", "xv"):
            g.input(name, [1, n, H * D])
        heads = []
        for name in ("xq", "xk", "xv"):
            shape = g.const(np.array([0, n, H, D], dtype=np.int64), "hs")
            r = g.node("Reshape", [name, shape], out=f"{name}_r")
            heads.append(g.node("Transpose", [r], out=f"{name}_t",
                                perm=[0, 2, 1, 3]))
        q, k, v = heads
    else:
        for name in ("q", "k", "v"):
            g.input(name, [1, H, n, D])
        q, k, v = "q", "k", "v"
    kt = g.node("Transpose", [k], out="k_T", perm=[0, 1, 3, 2])
    s = g.node("MatMul", [q, kt], out="scores")
    b = g.init("bias", bias)
    s = g.node("Add", [s, b], out="biased")
    p = g.node("Softmax", [s], out="probs", axis=-1)
    ctx = g.node("MatMul", [p, v], out="ctx")
    if split:
        ctx = g.node("Transpose", [ctx], out="ctx_t", perm=[0, 2, 1, 3])
        merge = g.const(np.array([0, n, H * D], dtype=np.int64), "merge")
        ctx = g.node("Reshape", [ctx, merge], out="merged")
    g.output(ctx, [1, n, H * D] if split else [1, H, n, D])
    return g.model()


def _both_reports(split: bool, swap=None):
    """optimize() on the port's and JAX's QModel of ``_hs_graph`` (both
    quantized with JAX's stats); with ``swap`` (a shape), the quantized bias
    constant of both becomes zeros of that shape and the fusion pass alone
    runs (its fusion_report is returned)."""
    bias = _bias("per_head", 8)
    rng = np.random.default_rng(1)
    shape = (1, 8, H * D) if split else (1, H, 8, D)
    xs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    jq = nq.Model.from_onnx(_hs_graph(JGraphBuilder, bias, split))
    stats = jq.calibration_stats(xs)
    jq = jq.quantize(bit_width=8, stats=stats)
    tq = Model.from_onnx(_hs_graph(GraphBuilder, bias, split),
                         device="cpu").quantize(bit_width=8, stats=stats)
    unfused = tq(xs)[0]
    if swap is not None:
        for v in jq.values:
            if isinstance(v, JConstant) and v.name == "bias":
                d = v.data
                v.data = JQTensor(jnp.zeros(swap, jnp.int32), d.bit_width,
                                  d.scale, d.zero_point)
        for v in tq.values:
            if isinstance(v, Constant) and v.name == "bias":
                d = v.data
                v.data = QTensor(torch.zeros(swap, dtype=torch.int32),
                                 d.bit_width, d.scale, d.zero_point)
        tq.invalidate_params()
        # the swapped constant no longer broadcasts, so no forward (as
        # optimize()'s later passes run) can follow: the fusion pass alone
        jq.fuse_attention()
        tq.fuse_attention()
        return jq.fusion_report, tq.fusion_report, tq, xs, unfused
    trep = tq.optimize()
    jrep = jq.optimize()
    # JAX's report has passes the port does not have; compare the port's
    return {key: jrep[key] for key in trep}, trep, tq, xs, unfused


def test_biased_head_split_fuses_as_jax():
    """The head-split chain fuses with the bias as the 4th input; the
    report equals JAX's and fused == unfused bit for bit."""
    jrep, trep, tq, xs, unfused = _both_reports(split=True)
    assert trep == jrep
    assert trep["fuse_attention"] == 1 and trep["fusion_failures"] == []
    fnodes = [n for n in tq.nodes if n.op == "FusedAttentionHS"]
    assert [len(n.inputs) for n in fnodes] == [4]
    assert fnodes[0].inputs[3].name == "bias"
    np.testing.assert_array_equal(tq(xs)[0], unfused)


def test_plain_form_bias_failure_carries_jax_text():
    """On pre-split heads the head split does not match, and a bias never
    fuses plainly: JAX's failure, text for text."""
    jrep, trep, _, _, _ = _both_reports(split=False)
    assert trep == jrep
    assert trep["fuse_attention"] == 0
    assert [r for _, r in trep["fusion_failures"]] == [
        "score-bias constant present but the head-split pattern did not "
        "match (bias fuses via FusedAttentionHS only)"]


def test_head_dim_failure_carries_jax_text():
    """A bias whose head dim is neither 1 nor num_heads: JAX's failure,
    text for text."""
    jrep, trep, _, _, _ = _both_reports(split=True, swap=(1, 3, 8, 8))
    assert trep == jrep
    assert trep["fused"] == 0
    assert [r for _, r in trep["failures"]] == [
        f"score-bias constant head dim 3 is not 1 or num_heads {H}"]
