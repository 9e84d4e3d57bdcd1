"""The plain PyTorch version of the port's fused attention kernel
(numpy_quant_tpu_torch.kernels.attention) held against the JAX package's
Pallas ``fused_attention_hs`` (interpret mode, TPU-mode numerics).

Expected: equality. Tolerance: the exp and the row sum run in another
order than XLA's, so a quantized probability may flip by one step.
Each flip moves the f32 outputs of its (row, head) block by at most
255*sp*sv and an int8 output by at most 1; at most 1% of the blocks may
differ. The flip count is printed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpy_quant_tpu.kernels.attention import fused_attention_hs as jax_hs
from numpy_quant_tpu_torch.kernels import attention as TA

B, N, H, D = 2, 17, 4, 16  # N=17 is ragged against both 8 and 128
# calibrated-looking (not round) scales: round ones put many requant
# results exactly on rounding ties
QP = dict(scaling=0.25, sq=0.0513, zq=3, sk=0.0437, zk=-5, sv=0.0317,
          zv=7, sp=np.float32(1.0 / 255.0), zp_p=-128, bit_width=8)
OUT_REQUANT = (0.0213, 4)
SCORE_MAX = 3.17


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _inputs(nq, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, size=(B, N, H * D)).astype(np.int8)
    k = rng.integers(-128, 128, size=(B, N, H * D)).astype(np.int8)
    v = rng.integers(-128, 128, size=(B, N, H * D)).astype(np.int8)
    return q[:, :nq].copy(), k, v


def _both(nq, fast, out_requant, score_max):
    q, k, v = _inputs(nq)
    kw = dict(QP, num_heads=H, fast=fast, score_max=score_max,
              out_requant=out_requant)
    want = np.asarray(jax_hs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, **kw))
    got = TA.fused_attention_hs_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **kw).numpy()
    return want, got


def _check_flips(want, got, out_requant):
    assert want.shape == got.shape and want.dtype == got.dtype
    diff = np.abs(want.astype(np.float64) - got.astype(np.float64))
    blocks = diff.reshape(B, -1, H, D).max(axis=-1)
    flips = int((blocks > 0).sum())
    print(f"flipped (row, head) blocks: {flips} of {blocks.size}")
    per_flip = 1.0 if out_requant is not None \
        else 255.0 * float(QP["sp"]) * QP["sv"] * (1 + 1e-6)
    assert diff.max(initial=0.0) <= per_flip
    assert flips <= max(1, 0.01 * blocks.size)


@pytest.mark.parametrize("nq", [N, 1])
@pytest.mark.parametrize("out_requant", [None, OUT_REQUANT])
def test_exact_matches_jax(nq, out_requant):
    want, got = _both(nq, False, out_requant, None)
    _check_flips(want, got, out_requant)


@pytest.mark.parametrize("score_max", [None, SCORE_MAX])
@pytest.mark.parametrize("nq", [N, 1])
@pytest.mark.parametrize("out_requant", [None, OUT_REQUANT])
def test_fast_matches_jax(nq, out_requant, score_max):
    want, got = _both(nq, True, out_requant, score_max)
    _check_flips(want, got, out_requant)


@pytest.mark.parametrize("fast", [False, True])
def test_wrapper_takes_plain_version_on_cpu(fast):
    q, k, v = (torch.from_numpy(a) for a in _inputs(N, seed=1))
    kw = dict(QP, num_heads=H, fast=fast, out_requant=OUT_REQUANT)
    before = TA.fused_attention_hs.launches
    out = TA.fused_attention_hs(q, k, v, **kw)
    assert TA.fused_attention_hs.launches == before
    np.testing.assert_array_equal(
        out.numpy(), TA.fused_attention_hs_reference(q, k, v, **kw).numpy())


def test_wrapper_rejects_bad_operands():
    q, k, v = (torch.from_numpy(a) for a in _inputs(N))
    kw = dict(QP, num_heads=H)
    with pytest.raises(TypeError):
        TA.fused_attention_hs(q.to(torch.int32), k, v, **kw)
    with pytest.raises(ValueError):
        TA.fused_attention_hs(q, k[:, :5], v, **kw)
    with pytest.raises(ValueError):
        TA.fused_attention_hs(q, k, v, **dict(kw, num_heads=3))


# -- the kernels' launch plans (pure Python, mirrored by the CUDA sources) --

SMEM = 232448  # bytes of shared memory one block may use on an H100


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d", TA.KERNEL_DIMS)
def test_monolithic_plan_fits_every_dispatched_call(d, exact):
    """Every call the dispatch sends to the monolithic kernel (N <= 896:
    full q, narrow q, 128 query rows) at ViT-, T5- and single-head batch
    sizes gets a plan, in the exact and the fast forms, whose shared
    memory fits one block, whose CTAs cover the query rows, and that
    stages K and V in turns only in one pass."""
    for n in range(1, 897):
        for nq in sorted({1, min(n, 128), n}):
            assert not TA.blockwise(n, None, nq=nq)
            for bh in (1, 64, 96 * 12):
                plan = TA.hs_plan(nq, n, d, bh, exact=exact)
                assert plan["smem"] == TA.hs_smem_bytes(
                    n, d, plan["warps"], plan["kv_both"], exact) <= SMEM
                # a row group per warp pair (exact) or per warp (fast)
                per_group = 2 if exact else 1
                groups = plan["warps"] // per_group
                assert groups * per_group == plan["warps"]
                rows = 16 * groups * plan["passes"]
                assert plan["grid"] == (-(-nq // rows), bh)
                assert plan["kv_both"] or plan["passes"] == 1


@pytest.mark.parametrize("nq,n,d,bh,exact,want", [
    # ViT-Base B=96: one CTA of 4 row groups per (batch row, head)
    (197, 197, 64, 96 * 12, True, (8, 4, True, 110720)),
    (197, 197, 64, 96 * 12, False, (4, 4, True, 51328)),
    (197, 197, 64, 8 * 12, True, (8, 1, True, 110720)),  # ViT-Base B=8
    (1, 197, 64, 8 * 12, True, (8, 1, True, 110720)),    # narrowed layer
    (1, 197, 64, 8 * 12, False, (4, 1, True, 51328)),
    (128, 128, 64, 8 * 8, True, (8, 1, True, 65792)),    # T5 decoder self
    (128, 512, 64, 8 * 8, True, (4, 1, True, 161280)),   # T5 cross
    (128, 512, 64, 8 * 8, False, (4, 1, True, 112384)),
    # called directly past the dispatch: K and V in turns on the exact form
    (1000, 1000, 64, 4, True, (2, 1, False, 169344)),
    (1000, 1000, 64, 4, False, (4, 1, True, 220928)),
    (896, 896, 128, 2, True, (2, 1, False, 205952)),     # K, V fill a block
    # the fast forms take turns too from N = 737 at D = 128 (K is read
    # again in their second score pass, so V is staged after it)
    (768, 768, 128, 2, False, (4, 1, False, 165888)),
    (896, 896, 128, 2, False, (4, 1, False, 193024)),
])
def test_monolithic_plan_at_path_shapes(nq, n, d, bh, exact, want):
    plan = TA.hs_plan(nq, n, d, bh, exact=exact)
    assert (plan["warps"], plan["passes"], plan["kv_both"],
            plan["smem"]) == want


def test_monolithic_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        TA.hs_plan(2048, 2048, 128, 1)
    with pytest.raises(ValueError, match="shared memory"):
        TA.hs_plan(1800, 1800, 128, 1, exact=False)


def test_kernel_forms_cover_bias_in_and_out():
    """Each head-split kernel builds one instantiation per head dim,
    softmax form, and score bias compiled in or out; a call picks by
    whether it has a bias and by its form, and each wrapper counts its
    launches by instantiation."""
    assert TA.hs_form(64, False, "exact") == "d64:exact"
    assert TA.hs_form(64, True, TA.softmax_form(True, None)) == "d64+bias:fast"
    assert TA.softmax_form(True, SCORE_MAX) == "shift"
    assert len(set(TA.HS_FORMS)) == 2 * 3 * len(TA.KERNEL_DIMS)
    for fn in (TA.fused_attention_hs, TA.fused_attention_hs_blockq):
        assert set(fn.launches_by_form) == set(TA.HS_FORMS)
    # the CPU path takes the plain version and counts no launch
    q, k, v = (torch.from_numpy(a) for a in _inputs(N))
    before = dict(TA.fused_attention_hs.launches_by_form)
    TA.fused_attention_hs(q, k, v, **dict(QP, num_heads=H))
    assert TA.fused_attention_hs.launches_by_form == before
