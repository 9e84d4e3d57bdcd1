"""The port's weight-only layers held against the JAX package in TPU-mode
numerics (x64 off): ``weight_only_scales``, ``Model.quantize_weights``
(payloads, packed bytes and grouped scales bit-equal on a small GPT: 2
layers, n_embd 64, 4 heads, vocab 96), the plain version of
``splitk_wo_matmul`` against the Pallas kernel in interpret mode, the
Gemm weight-only branch, and the ``Split``/``Slice`` ops.

Tolerances: ``splitk_wo_matmul`` in f32 within rtol = atol = 2e-5 of the
Pallas kernel (the same dequantized operands, sums in another order);
in bf16 within 2^-7 * max|y| (two bf16 steps at the largest output: each
side rounds its f32 sum to bf16 once). The Gemm branch within 1e-6 of
JAX (f32 products, another summation order). Split and Slice are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import GPT2Config
from transformers.models.gpt2.modeling_gpt2 import GPT2LMHeadModel

import numpy_quant_tpu as nq
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.kernels.pack import pack_splitk as j_pack_splitk
from numpy_quant_tpu.kernels.qmatmul import splitk_wo_matmul as j_wo
from numpy_quant_tpu.models import gpt as JG
from numpy_quant_tpu.onnx.builder import GraphBuilder as JGraphBuilder
from numpy_quant_tpu.quantization import weight_only_scales as j_scales
from numpy_quant_tpu.tensor import PackedQTensor as JPackedQTensor
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.graph import Constant
from numpy_quant_tpu_torch.kernels import qmatmul as TQ
from numpy_quant_tpu_torch.models import gpt as TG
from numpy_quant_tpu_torch.onnx.builder import GraphBuilder as TGraphBuilder
from numpy_quant_tpu_torch.quantization import weight_only_scales
from numpy_quant_tpu_torch.tensor import PackedQTensor, QTensor

CFG = dict(vocab_size=96, n_positions=16, n_embd=64, n_layer=2, n_head=4)
# weight-only configurations: (bit_width, group_size); 9 weights each
WO_CONFIGS = {"w8": (8, None), "w4g8": (4, 8), "w2g16": (2, 16)}
N_WEIGHTS = 4 * CFG["n_layer"] + 1


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def gpt():
    weights = TG.random_gpt2_weights(CFG, seed=0)
    hf = GPT2LMHeadModel(GPT2Config(**CFG, activation_function="gelu")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    with jax.enable_x64(False):
        jproto = JG.gpt_decode_step(module=hf, batch_size=2, max_len=16)
    return dict(jproto=jproto,
                tproto=TG.gpt_decode_step(weights, CFG, batch_size=2,
                                          max_len=16))


@pytest.mark.parametrize("bits,axis,per_channel,group_size,groupable", [
    (8, 1, True, None, False), (8, 0, True, None, False),
    (4, 1, False, None, False), (4, 1, True, 8, True),
    (2, 1, True, 16, True), (4, 1, True, 24, True),  # 24 does not divide K
])
def test_weight_only_scales_bit_equal(bits, axis, per_channel, group_size,
                                      groupable):
    arr = (np.random.default_rng(bits + axis).normal(size=(64, 40)) * 0.02) \
        .astype(np.float32)
    arr[:, 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    kw = dict(per_channel=per_channel, group_size=group_size,
              groupable=groupable)
    full, store = weight_only_scales(arr, bits, axis, **kw)
    jfull, jstore = j_scales(arr, bits, axis, **kw)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(jfull))
    assert np.asarray(full).dtype == np.asarray(jfull).dtype == np.float32
    assert (store is None) == (jstore is None)
    if store is not None:
        np.testing.assert_array_equal(store, jstore)


@pytest.mark.parametrize("config", list(WO_CONFIGS))
def test_quantize_weights_bit_equal(gpt, config):
    """Counts, kinds, payloads (packed bytes or int8), column sums and
    scales (grouped [K/g, N] included) equal JAX's."""
    bits, group = WO_CONFIGS[config]
    jm = nq.Model.from_onnx(gpt["jproto"])
    tm = Model.from_onnx(gpt["tproto"], device="cpu")
    assert jm.quantize_weights(bit_width=bits, group_size=group) \
        == tm.quantize_weights(bit_width=bits, group_size=group) == N_WEIGHTS
    jw = {v.name: v.data for v in jm.values if isinstance(v, JConstant)
          and isinstance(v.data, (JQTensor, JPackedQTensor))}
    tw = {v.name: v.data for v in tm.values if isinstance(v, Constant)
          and isinstance(v.data, (QTensor, PackedQTensor))}
    assert set(tw) == set(jw) and len(tw) == N_WEIGHTS
    grouped = 0
    for name, t in tw.items():
        j = jw[name]
        assert t.bit_width == j.bit_width == bits, name
        np.testing.assert_array_equal(np.asarray(t.scale),
                                      np.asarray(j.scale), err_msg=name)
        grouped += np.asarray(t.scale).ndim == 2 \
            and np.asarray(t.scale).shape[0] > 1
        if bits == 8:
            assert isinstance(t, QTensor) and isinstance(j, JQTensor), name
            np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
            continue
        assert isinstance(t, PackedQTensor) and isinstance(j, JPackedQTensor)
        assert (t.layout, t.k, t.n) == (j.layout, j.k, j.n), name
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))
        np.testing.assert_array_equal(t.colsum.numpy(), np.asarray(j.colsum))
    assert grouped == (N_WEIGHTS if group else 0)


def test_quantize_weights_refuses_a_qmodel(gpt):
    tm = Model.from_onnx(gpt["tproto"], device="cpu")
    q = tm.quantize(stats={v.name: (np.float32(-1), np.float32(1))
                           for v in tm.values} | {
        n.outputs[0].name: (np.float32(-1), np.float32(1))
        for n in tm.nodes for _ in [0] if n.outputs})
    with pytest.raises(ValueError, match="FLOAT-executor"):
        q.quantize_weights()


# -- splitk_wo_matmul: the plain version against the Pallas kernel ----------

RNG = np.random.default_rng(61)


def _wo_case(bits, k, n, m, g, seed):
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int8)
    s = np.abs(rng.normal(size=(g, n))).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = w if bits == 8 else j_pack_splitk(w, bits)
    return x, packed, s


@pytest.mark.parametrize("bits,K,N,M,g", [
    (4, 256, 96, 7, 1), (4, 256, 96, 7, 4), (2, 128, 64, 5, 2),
    (8, 200, 50, 3, 1), (1, 256, 64, 4, 2), (4, 384, 130, 9, 6),
])
def test_splitk_wo_reference_matches_jax(bits, K, N, M, g):
    """The cases of the JAX package's own kernel test: per-tensor and
    per-channel (g=1), per-field groups, field-spanning groups (g < r),
    ragged N."""
    x, packed, s = _wo_case(bits, K, N, M, g, seed=bits * 100 + g)
    for scale in ([s] if g > 1 else [s, s[:, :1].copy()]):  # [1, 1]: per tensor
        want = np.asarray(j_wo(jnp.asarray(x), jnp.asarray(packed),
                               jnp.asarray(scale), bits=bits, interpret=True))
        got = TQ.splitk_wo_matmul_reference(
            torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scale), bits=bits)
        assert got.dtype == torch.float32 and got.shape == (M, N)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("g", [1, 2, 8])
def test_splitk_wo_reference_bf16_matches_jax(g):
    """bf16 x: each dequantized weight rounds to bf16 before the dot, the
    sum runs in f32 and rounds to bf16 once, in both."""
    x, packed, s = _wo_case(4, 256, 128, 16, g, seed=g)
    want = np.asarray(j_wo(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed),
                           jnp.asarray(s), bits=4, interpret=True))
    got = TQ.splitk_wo_matmul_reference(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(packed),
        torch.from_numpy(s), bits=4)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    want = want.astype(np.float32)
    off = int((got != want).sum())
    print(f"bf16 outputs one rounding apart: {off} of {got.size}")
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_splitk_wo_infeasible_groups_raise_in_both():
    """Groups that tile neither within nor across the split-K fields:
    gsz 128 against a field height of 192."""
    x, packed, s = _wo_case(4, 384, 128, 16, 3, seed=5)
    with pytest.raises(ValueError, match="group_size"):
        j_wo(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s), bits=4,
             interpret=True)
    for fn in (TQ.splitk_wo_matmul, TQ.splitk_wo_matmul_reference):
        with pytest.raises(ValueError, match="group_size"):
            fn(torch.from_numpy(x), torch.from_numpy(packed),
               torch.from_numpy(s), bits=4)


@pytest.mark.parametrize("bits,g", [
    (4, 2), (4, 3), (4, 48), (2, 2), (2, 4), (1, 4), (1, 2), (1, 3), (8, 3)])
def test_weight_only_matmul_routes_groups_as_jax(bits, g, monkeypatch):
    """K = 384: groups within a field, of one field or of several fields
    (g=4 at 1 bit and g=2 at 2 bits: gsz = 2 * KR) take splitk_wo_matmul
    under "kernel"; groups that tile the fields neither way (gsz 128
    against KR 192 or 48) take the unpack path, where the JAX kernel
    refuses them. Both routes agree with the unpack result within
    2e-5 * max|y| (f32 sums in another order: dequantized dot against the
    group-batched product)."""
    from numpy_quant_tpu_torch import config
    from numpy_quant_tpu_torch.ops import registry
    from numpy_quant_tpu_torch.tensor import FTensor

    k, n = 384, 16
    x, packed, s = _wo_case(bits, k, n, 3, g, seed=g)
    try:
        j_wo(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s), bits=bits,
             interpret=True)
        jax_takes_it = True
    except ValueError:
        jax_takes_it = False
    assert TQ.wo_groups_tile(k, packed.shape[0], g, bits) == jax_takes_it
    calls = []
    real = TQ.splitk_wo_matmul
    monkeypatch.setattr(TQ, "splitk_wo_matmul",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    b = PackedQTensor(torch.from_numpy(packed), None, k, n, bits, s,
                      layout="splitk")
    xt = FTensor(torch.from_numpy(x))
    monkeypatch.setattr(config, "packed_execution", "unpack")
    want = registry._weight_only_matmul(xt, b).data
    monkeypatch.setattr(config, "packed_execution", "kernel")
    got = registry._weight_only_matmul(xt, b).data
    assert len(calls) == int(jax_takes_it)
    assert np.abs(got.numpy() - want.numpy()).max() \
        <= 2e-5 * np.abs(want.numpy()).max()


def test_splitk_wo_wrapper_takes_plain_version_on_cpu():
    x, packed, s = _wo_case(2, 128, 64, 5, 2, seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(s))
    before = TQ.splitk_wo_matmul.launches
    out = TQ.splitk_wo_matmul(*args, bits=2, group_size=64)
    assert TQ.splitk_wo_matmul.launches == before
    np.testing.assert_array_equal(
        out.numpy(), TQ.splitk_wo_matmul_reference(*args, bits=2).numpy())


def test_splitk_wo_wrapper_rejects_bad_operands():
    x, packed, s = (torch.from_numpy(a) for a in _wo_case(4, 64, 16, 3, 1, 1))
    with pytest.raises(TypeError):  # float x only
        TQ.splitk_wo_matmul(x.to(torch.int32), packed, s, bits=4)
    with pytest.raises(ValueError):  # too few packed rows for K
        TQ.splitk_wo_matmul(x, packed[:8], s, bits=4)
    with pytest.raises(ValueError):  # split-K does not pack 3 bits
        TQ.splitk_wo_matmul(x, packed, s, bits=3)
    with pytest.raises(TypeError):  # 8 bits take the int8 weight itself
        TQ.splitk_wo_matmul(x, packed, s, bits=8)
    with pytest.raises(ValueError):  # group_size disagrees with the scale
        TQ.splitk_wo_matmul(x, packed, torch.ones(4, 16), bits=4,
                            group_size=8)
    with pytest.raises(ValueError):  # per-channel scale of the wrong width
        TQ.splitk_wo_matmul(x, packed, torch.ones(1, 15), bits=4)


# -- Gemm weight-only, Split and Slice against JAX --------------------------

def _gemm_graph(builder_cls, w1, b1, w2):
    """x [4, 16] -> Gemm(transB=1, W1 [8, 16], b1) -> Gemm(W2 [8, 5],
    alpha 0.5) -> y."""
    g = builder_cls("gemm_wo")
    x = g.input("x", [4, 16])
    h = g.node("Gemm", [x, g.init("w1", w1), g.init("b1", b1)], out="h",
               transB=1)
    y = g.node("Gemm", [h, g.init("w2", w2)], out="y", alpha=0.5)
    g.output(y, [4, 5])
    return g.model()


@pytest.mark.parametrize("bits,per_channel,pack", [
    (8, True, False), (8, False, False), (4, True, True)])
def test_gemm_weight_only_matches_jax(bits, per_channel, pack):
    rng = np.random.default_rng(bits)
    w1 = rng.normal(size=(8, 16)).astype(np.float32)
    b1 = rng.normal(size=(8,)).astype(np.float32)
    w2 = rng.normal(size=(8, 5)).astype(np.float32)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    jm = nq.Model.from_onnx(_gemm_graph(JGraphBuilder, w1, b1, w2))
    tm = Model.from_onnx(_gemm_graph(TGraphBuilder, w1, b1, w2), device="cpu")
    kw = dict(bit_width=bits, per_channel=per_channel, pack=pack)
    assert jm.quantize_weights(**kw) == tm.quantize_weights(**kw) == 2
    scales = {v.name: np.asarray(v.data.scale) for v in tm.values
              if isinstance(v, Constant)
              and isinstance(v.data, (QTensor, PackedQTensor))}
    if per_channel:  # the channel axis follows transB
        assert scales["w1"].shape == (8, 1) and scales["w2"].shape == (1, 5)
    want = np.asarray(jm([x])[0])
    got = tm([x])[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(got, Model.from_onnx(
        _gemm_graph(TGraphBuilder, w1, b1, w2), device="cpu")([x])[0],
        rtol=0, atol=1e-7)  # the weight rounding is real


def _split_slice_graph(builder_cls):
    """Split in its three forms and Slice with axes, steps and negative
    bounds over one [2, 12, 6] input."""
    g = builder_cls("split_slice")
    x = g.input("x", [2, 12, 6])
    a = g.node("Split", [x], out="a", n_outputs=3, axis=1, num_outputs=3)
    sizes = g.const(np.array([2, 4], dtype=np.int64), "sizes")
    b = g.node("Split", [x, sizes], out="b", n_outputs=2, axis=-1)
    c = g.node("Split", [x], out="c", n_outputs=3, axis=1, split=[5, 5, 2])
    d = g.node("Split", [x], out="d", n_outputs=5, axis=1, num_outputs=5)

    def ints(v, hint):
        return g.const(np.array(v, dtype=np.int64), hint)

    s1 = g.node("Slice", [x, ints([1, -4], "st"), ints([11, 100], "en"),
                          ints([1, 2], "ax"), ints([3, 1], "sp")], out="s1")
    s2 = g.node("Slice", [x, ints([-1], "st"), ints([-13], "en"),
                          ints([1], "ax"), ints([-2], "sp")], out="s2")
    s3 = g.node("Slice", [x, ints([0, 1], "st"), ints([1, 3], "en")],
                out="s3")
    outs = list(a) + list(b) + list(c) + list(d) + [s1, s2, s3]
    for o in outs:
        g.output(o)
    return g.model(), len(outs)


def test_split_and_slice_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 12, 6)).astype(np.float32)
    jproto, n = _split_slice_graph(JGraphBuilder)
    tproto, _ = _split_slice_graph(TGraphBuilder)
    want = nq.Model.from_onnx(jproto)([x])
    got = Model.from_onnx(tproto, device="cpu")([x])
    assert len(got) == len(want) == n
    for w, t in zip(want, got):
        w = np.asarray(w)
        assert w.shape == t.shape
        np.testing.assert_array_equal(t, w)


# (M, K, N): GPT-2 small's five decode shapes at B=8 (c_attn, attn c_proj,
# c_fc, mlp c_proj, the tied head), then chip_smoke.py's ragged check shapes
WO_PLAN_SHAPES = [(8, 768, 2304), (8, 768, 768), (8, 768, 3072),
                  (8, 3072, 768), (8, 768, 50257),
                  (133, 384, 149), (7, 384, 300), (133, 203, 149)]


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("m,k,n", WO_PLAN_SHAPES)
def test_wo_plan_covers_every_packed_row_once(m, k, n, bits):
    """splitk_wo_matmul's launch plan on a 132-SM H100: a power-of-two
    cluster of at most 16 blocks along K whose ranks take chunk-aligned
    runs of packed rows, together every row of the payload exactly once;
    at GPT-2's four per-layer decode shapes (W4) one to two blocks per SM,
    and the LM head needs no split."""
    sms = 132
    kr = k if bits == 8 else -(-k // (8 // bits))
    plan = TQ.wo_plan(m, n, kr, bits, sms)
    c, per = plan["cluster"], plan["rows_per_rank"]
    assert 1 <= c <= TQ.WO_MAX_CLUSTER and c & (c - 1) == 0
    assert per % (TQ.WO_CHUNK // (8 // bits)) == 0
    covered = np.zeros(kr, np.int64)
    for rank in range(c):
        covered[rank * per:min(kr, (rank + 1) * per)] += 1
    assert (covered == 1).all()
    if bits == 4 and m == 8:
        if n == 50257:
            assert c == 1
        else:
            assert sms <= plan["blocks"] <= 2 * sms, plan
