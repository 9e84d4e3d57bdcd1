"""The port's causal attention held against the JAX package: the plain
PyTorch versions of the monolithic and blockwise kernels
(numpy_quant_tpu_torch.kernels.attention) against the Pallas
``fused_attention_hs`` in interpret mode, the causal-mask matcher, and
the int8 GPT causal LM (2 layers, n_embd 32, 2 heads, vocab 96) end to
end at seq_len 16 (monolithic) and 1024 (blockwise), in TPU-mode
numerics (x64 off).

Tolerances: the exact forms are bit-equal to JAX's, the fast forms
within atol 2e-2 (JAX's own bound between its fast and exact kernels;
the count of differing outputs is printed). The blockwise plain version
equals JAX's block_q=8 grid bit for bit at N=50 in every form the file
holds. At N=1024 rows of 1024 probabilities sum in another order than
XLA's, so at most 1% of the (row, head) blocks may differ, each by one
probability step (255*sp*sv, or that over the requant scale, rounded,
on int8 out); the count is printed (1 of 2048 blocks when this was
written). End to end, the port's fused f32 forward
equals its unfused forward bit for bit; against JAX, quantized
intermediates (the attention outputs among them) differ by at most 1
LSB on at most 0.1% of entries, where a float op (exp, erf, a LayerNorm
reduce) rounds across a rint boundary in another order; logits agree
within 1e-4 when no intermediate differs, else within 1e-2 * max|logit|
(the bounds of tests/test_torch_vit.py). The bf16 serving mode is finite
and within 5% of max|logit| of f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import GPT2Config
from transformers.models.gpt2.modeling_gpt2 import GPT2LMHeadModel

import numpy_quant_tpu as nq
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.graph import Node as JNode
from numpy_quant_tpu.graph import Variable as JVariable
from numpy_quant_tpu.kernels.attention import fused_attention_hs as jax_hs
from numpy_quant_tpu.models import gpt as JG
from numpy_quant_tpu.passes.attention import _match_causal_mask as j_match
from numpy_quant_tpu.tensor import FTensor as JFTensor
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch import onnx as T_ONNX
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.graph import Constant, Node, Variable
from numpy_quant_tpu_torch.kernels import attention as TA
from numpy_quant_tpu_torch.models import gpt as TG
from numpy_quant_tpu_torch.ops.registry import attention_call
from numpy_quant_tpu_torch.passes.attention import (_match_causal_mask,
                                                    _match_score_bias)
from numpy_quant_tpu_torch.tensor import FTensor, QTensor

H = 2
# calibrated-looking (not round) scales: round ones put many requant
# results exactly on rounding ties
QP = dict(scaling=0.35, sq=0.0213, zq=3, sk=0.0311, zk=-2, sv=0.0517,
          zv=4, sp=np.float32(1.0 / 255.0), zp_p=-128, bit_width=8)
OUT_REQUANT = (0.0213, 4)
SCORE_MAX = 3.17
MASK = float(np.float32(-3.2e8))  # a dequantized -1e9-style mask value
WINDOW = 5
MODES = {"exact": (False, None), "fast": (True, None),
         "fast_shift": (True, SCORE_MAX)}
FORMS = {"none": (None, None), "causal": (MASK, None), "window": (MASK, WINDOW)}

CFG = dict(vocab_size=96, n_positions=1024, n_embd=32, n_layer=2, n_head=2)
B_LM = 2


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _inputs(b, n, d, nq=None, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.integers(-100, 100, size=(b, n, H * d)).astype(np.int8)
               for _ in range(3))
    return q[:, :nq or n].copy(), k, v


def _kw(mode, form, out_requant):
    fast, score_max = MODES[mode]
    mask, window = FORMS[form]
    return dict(QP, num_heads=H, fast=fast, score_max=score_max,
                out_requant=out_requant, causal_mask_val=mask,
                causal_window=window)


def _pair(q, k, v, kw, block_q=None):
    """(JAX interpret-mode output, the port's plain output) on one input."""
    want = np.asarray(jax_hs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_q=block_q, interpret=True, **kw))
    got = TA.fused_attention_hs(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), block_q=block_q,
                                **kw).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    return want, got


def _hold(want, got, fast, flips_allowed=False, out_requant=None):
    diff = np.abs(want.astype(np.float64) - got.astype(np.float64))
    print(f"outputs differing: {int((diff > 0).sum())} of {diff.size}, "
          f"max {diff.max(initial=0.0):.3g}")
    if flips_allowed:
        # one probability step moves its (row, head) block by at most
        # 255*sp*sv, or that over the requant scale (rounded) on int8 out
        step = 255.0 * float(QP["sp"]) * QP["sv"] * (1 + 1e-6)
        if out_requant is not None:
            step = float(int(step / out_requant[0]) + 1)
        blocks = diff.reshape(*diff.shape[:2], H, -1).max(axis=-1)
        flips = int((blocks > 0).sum())
        print(f"flipped (row, head) blocks: {flips} of {blocks.size}")
        assert diff.max(initial=0.0) <= step
        assert flips <= 0.01 * blocks.size
    elif fast:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=0, atol=2e-2)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_requant", [None, OUT_REQUANT])
@pytest.mark.parametrize("form", ["causal", "window"])
@pytest.mark.parametrize("mode,n", [("exact", 12), ("exact", 20),
                                    ("fast", 20), ("fast_shift", 12)])
def test_monolithic_causal_matches_jax(mode, n, form, out_requant):
    """The plain monolithic version's causal and window forms against
    JAX's monolithic kernel (N below the blockwise switch)."""
    assert not TA.blockwise(n, None)
    q, k, v = _inputs(2, n, 8, seed=n)
    want, got = _pair(q, k, v, _kw(mode, form, out_requant))
    _hold(want, got, MODES[mode][0])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form,nq", [("none", None), ("causal", None),
                                     ("window", None), ("none", 1),
                                     ("none", 3)])
def test_blockwise_matches_jax_grid(form, nq, mode):
    """The plain blockwise version in block_q=8 tiles against JAX's
    block_q=8 grid at ragged N=50: no mask, causal, window, and narrow q
    (1 and 3 rows against all keys)."""
    q, k, v = _inputs(2, 50, 8, nq=nq, seed=7)
    for rq in (None, OUT_REQUANT):
        want, got = _pair(q, k, v, _kw(mode, form, rq), block_q=8)
        _hold(want, got, MODES[mode][0])


def test_blockwise_full_context_matches_jax():
    """N=1024 (B=1, H=2, D=64), causal, exact: JAX's auto-dispatched
    blockwise grid against the port's, both chosen by the N rule. Rows of
    1024 probabilities sum in another order than XLA's, so a few
    probabilities round one step apart (counted): at most 1% of the
    (row, head) blocks, each by one probability step."""
    assert TA.blockwise(1024, None)
    q, k, v = _inputs(1, 1024, 64, seed=3)
    want, got = _pair(q, k, v, _kw("exact", "causal", OUT_REQUANT))
    _hold(want, got, False, flips_allowed=True, out_requant=OUT_REQUANT)


def test_blockwise_plain_equals_monolithic_plain():
    """Each row sees the same full-row reductions in either plain
    version, so they agree bit for bit (memory grows with block_q * N in
    the blockwise one)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 50, 8, seed=11))
    for mode in MODES:
        for form in FORMS:
            kw = _kw(mode, form, None)
            np.testing.assert_array_equal(
                TA.fused_attention_hs_blockq_reference(q, k, v, block_q=16,
                                                       **kw).numpy(),
                TA.fused_attention_hs_reference(q, k, v, **kw).numpy())


@pytest.mark.parametrize("n,block_q,want,bias_heads", [
    pytest.param(n, bq, want, None, id=f"{n}-{bq}-{want}")
    for n, bq, want in ((1024, None, True), (1000, None, True),
                        (897, None, True), (896, None, False),
                        (197, None, False), (50, 8, True), (4096, None, True))
] + [pytest.param(n, None, want, 8, id=f"{n}-bias8-{want}")
     for n, want in ((128, False), (256, False), (257, True), (512, True))])
def test_dispatch(n, block_q, want, bias_heads):
    """JAX's rule: blockwise at round_up(N, 128) >= 1024 or a forced
    block_q (897 and 1000 pad to 1024 lanes, 896 does not), or with a
    score bias whose padded f32 block H * round_up(nq, 8) * round_up(N,
    128) * 4 passes 2 MiB (at t5-small's H=8: N=256 is exactly 2 MiB, 257
    pads to 264 rows x 384 lanes)."""
    assert TA.blockwise(n, block_q, nq=n, bias_heads=bias_heads) is want


def test_wrappers_take_plain_versions_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1024, 16, seed=5))
    kw = _kw("exact", "causal", OUT_REQUANT)
    before = (TA.fused_attention_hs.launches,
              TA.fused_attention_hs_blockq.launches)
    out = TA.fused_attention_hs(q, k, v, **kw)
    assert (TA.fused_attention_hs.launches,
            TA.fused_attention_hs_blockq.launches) == before
    np.testing.assert_array_equal(
        out.numpy(), TA.fused_attention_hs_blockq_reference(q, k, v,
                                                            **kw).numpy())
    with pytest.raises(ValueError, match="causal mask"):
        TA.fused_attention_hs(q[:, :1], k, v, **kw)
    with pytest.raises(ValueError, match="causal mask"):
        TA.fused_attention_hs_blockq(q[:, :3], k, v, **kw)


def test_registry_refuses_score_bias_operand():
    """The 4th FusedAttentionHS operand is accepted: dequantized as the
    unfused Add dequantizes it (a 32-bit bias on the scores' scale), its
    leading 1-dims dropped, broadcast to a contiguous float32 [H, nq, n];
    one that does not broadcast over the batch is refused."""
    qt = QTensor(torch.zeros(1, 4, 16, dtype=torch.int8), 8,
                 np.float32(0.1), None)
    attrs = dict(num_heads=2, scaling=1.0, probs_scale=1.0 / 255,
                 probs_zero_point=-128)
    raw = torch.arange(16, dtype=torch.int32).reshape(1, 1, 4, 4) - 8
    bias = QTensor(raw, 32, np.float32(0.25), None)
    *_, kw, narrow = attention_call([qt, qt, qt, bias], attrs)
    sb = kw["score_bias"]
    assert not narrow and sb.dtype == torch.float32 and sb.is_contiguous()
    assert tuple(sb.shape) == (2, 4, 4)
    want = bias.dequantize().data[0, 0]
    for h in range(2):
        np.testing.assert_array_equal(sb[h].numpy(), want.numpy())
    two_d = FTensor(torch.ones(4, 4))
    assert tuple(attention_call([qt, qt, qt, two_d], attrs)[3]["score_bias"]
                 .shape) == (2, 4, 4)
    assert attention_call([qt, qt, qt], attrs)[3]["score_bias"] is None
    with pytest.raises(ValueError, match="broadcast over the batch"):
        attention_call([qt, qt, qt, FTensor(torch.ones(2, 2, 4, 4))], attrs)


# -- the causal-mask matcher ---------------------------------------------


def _mask_graph(mask: np.ndarray):
    """Add(x, mask constant) in both packages' graphs: (port producer map
    and value, JAX producer map and value)."""
    tx, tc, to = Variable("x", [], []), \
        Constant("m", [], FTensor(torch.from_numpy(mask))), Variable("o", [], [])
    jx, jc, jo = JVariable("x", [], []), \
        JConstant("m", [], JFTensor(jnp.asarray(mask))), JVariable("o", [], [])
    tn = Node("add", "Add", {}, [tx, tc], [to])
    jn = JNode("add", "Add", {}, [jx, jc], [jo])
    return ({"o": tn}, to), ({"o": jn}, jo)


@pytest.mark.parametrize("kind", ["causal", "band3", "band1", "random",
                                  "small", "uneven"])
def test_causal_matcher_matches_jax(kind):
    """The full and banded (Mistral-style sliding-window) masks match with
    JAX's (value, window); a random bias, a mask above -1e4 and a mask of
    two values do not."""
    n = 8
    i, j = np.indices((n, n))
    m = np.float32(-1e9)
    masks = {
        "causal": np.where(j <= i, 0, m),
        "band3": np.where((j <= i) & (j > i - 3), 0, m),
        "band1": np.where(j == i, 0, m),
        "random": np.random.default_rng(0).normal(size=(n, n)),
        "small": np.where(j <= i, 0, np.float32(-100.0)),
        "uneven": np.where(j <= i, 0, np.where(j > i + 2, m, 2 * m)),
    }
    mask = masks[kind].astype(np.float32)[None, None]
    (tp, tv), (jp, jv) = _mask_graph(mask)
    t_node, t_val = _match_causal_mask(tp, tv)
    j_node, j_val = j_match(jp, jv)
    assert (t_node is None) == (j_node is None)
    assert t_val == j_val
    expect = {"causal": (float(m), None), "band3": (float(m), 3),
              "band1": (float(m), 1)}
    assert t_val == expect.get(kind)
    if kind == "random":
        assert _match_score_bias(tp, tv) is not None


# -- the int8 GPT causal LM end to end ------------------------------------


@pytest.fixture(scope="module")
def lm():
    weights = TG.random_gpt2_weights(CFG, seed=0)
    hf = GPT2LMHeadModel(GPT2Config(**CFG, activation_function="gelu",
                                    attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return dict(weights=weights, hf=hf, cache={})


def _jax_state(jq):
    consts = {}
    for v in jq.values:
        if isinstance(v, JConstant) and isinstance(v.data, JQTensor):
            zp = v.data.zero_point
            consts[v.name] = {"payload": np.asarray(v.data.data),
                              "scale": np.asarray(v.data.scale, np.float32),
                              "zero_point": None if zp is None else int(zp),
                              "bit_width": v.data.bit_width}
    qps = {name: (np.asarray(qp.scale, np.float32),
                  None if qp.zero_point is None else int(qp.zero_point))
           for name, qp in jq.quant_params.items()}
    return {"constants": consts, "quant_params": qps}


def _setup(lm, seq):
    """Both graphs at ``seq``, token embeddings of seeded ids, and the JAX
    QModel (calibrated on 2 sequences) before and after optimize()."""
    if seq in lm["cache"]:
        return lm["cache"][seq]
    with jax.enable_x64(False):
        jproto = JG.gpt_causal_lm(module=lm["hf"], batch_size=B_LM,
                                  seq_len=seq)
        wte = jproto._wte
        rng = np.random.default_rng(seq)
        calib = wte[rng.integers(0, CFG["vocab_size"], size=(2, seq))]
        x = wte[rng.integers(0, CFG["vocab_size"], size=(B_LM, seq))]
        stats = nq.Model.from_onnx(jproto).calibration_stats([calib])
        jq = nq.Model.from_onnx(jproto).quantize(bit_width=8, stats=stats)
        state = _jax_state(jq)
        jrep = jq.optimize()
        jy = jq([x], record=True)[0]
        jdata = {v.name: np.asarray(v.data.data) for v in jq.values
                 if isinstance(v, JVariable) and isinstance(v.data, JQTensor)
                 and v.data.bit_width <= 8}
    s = dict(tproto=TG.gpt_causal_lm(lm["weights"], CFG, batch_size=B_LM,
                                     seq_len=seq),
             x=x, calib=calib, stats=stats, state=state, jrep=jrep,
             jnodes={n.name: dict(n.attrs) for n in jq.nodes
                     if n.op == "FusedAttentionHS"},
             jy=np.asarray(jy), jdata=jdata)
    lm["cache"][seq] = s
    return s


def _port_qmodel(s, stats=None):
    tm = Model.from_onnx(s["tproto"], device="cpu")
    return tm.quantize(bit_width=8, stats=stats or s["stats"])


def test_quantize_carries_the_mask_constant_like_jax(lm):
    """quantize() turns each causal-mask initializer into the same 32-bit
    bias constant as JAX (clipped to -2^31 on the scores' scale), and
    load_jax_params installs JAX's."""
    s = _setup(lm, 16)
    tq = _port_qmodel(s)
    masks = {v.name: v.data for v in tq.values
             if isinstance(v, Constant) and v.name.endswith("causal_mask")}
    assert len(masks) == CFG["n_layer"]
    for name, t in masks.items():
        j = s["state"]["constants"][name]
        assert t.bit_width == j["bit_width"] == 32 and t.zero_point is None
        np.testing.assert_array_equal(t.data.numpy(), j["payload"])
        np.testing.assert_array_equal(np.asarray(t.scale), j["scale"])
    other = _port_qmodel(s, Model.from_onnx(s["tproto"], device="cpu")
                         .calibration_stats([s["calib"] * 3.0]))
    assert load_jax_params(other, s["state"]) == sum(
        isinstance(v, Constant) and isinstance(v.data, QTensor)
        for v in other.values)
    for name in masks:
        got = next(v.data for v in other.values if v.name == name)
        np.testing.assert_array_equal(got.data.cpu().numpy(),
                                      s["state"]["constants"][name]["payload"])


@pytest.mark.parametrize("seq", [16, 1024])
def test_optimize_report_matches_jax(lm, seq):
    """Both layers fuse with the same causal_mask_val bits, no window and
    no failures; every pass count equals JAX's."""
    s = _setup(lm, seq)
    tq = _port_qmodel(s)
    load_jax_params(tq, s["state"])
    trep = tq.optimize()
    print("optimize:", trep)
    for key in trep:
        assert trep[key] == s["jrep"][key], key
    assert trep["fuse_attention"] == CFG["n_layer"]
    assert trep["fusion_failures"] == []
    tnodes = {n.name: n.attrs for n in tq.nodes if n.op == "FusedAttentionHS"}
    assert set(tnodes) == set(s["jnodes"])
    for name, attrs in tnodes.items():
        want = s["jnodes"][name]
        assert np.float32(attrs["causal_mask_val"]) \
            == np.float32(want["causal_mask_val"]) < -1e4
        assert "causal_window" not in attrs and "causal_window" not in want
        assert attrs["score_max"] == want["score_max"]


@pytest.mark.parametrize("seq", [16, 1024])
def test_causal_lm_end_to_end(lm, seq, monkeypatch):
    """JAX's constants installed in the port: the fused f32 forward equals
    the port's unfused one bit for bit, goes through the monolithic (16)
    or blockwise (1024) wrapper, and meets the contract against JAX; the
    bf16 mode stays finite and close."""
    s = _setup(lm, seq)
    tq = _port_qmodel(s, Model.from_onnx(s["tproto"], device="cpu")
                      .calibration_stats([s["calib"] * 2.0]))
    load_jax_params(tq, s["state"])
    x = s["x"]
    unfused = tq([x])[0]
    tq.optimize()
    calls = []
    for fn in ("fused_attention_hs_monolithic", "fused_attention_hs_blockq"):
        wrapped = getattr(TA, fn)
        monkeypatch.setattr(TA, fn, lambda *a, _w=wrapped, _n=fn, **k:
                            calls.append(_n) or _w(*a, **k))
    fused = tq([x], record=True)[0]
    monkeypatch.undo()
    np.testing.assert_array_equal(fused, unfused)
    kind = "fused_attention_hs_blockq" if seq == 1024 \
        else "fused_attention_hs_monolithic"
    assert calls == [kind] * CFG["n_layer"]

    att_names = {n.outputs[0].name for n in tq.nodes
                 if n.op == "FusedAttentionHS"}
    flips = total = att_flips = att_total = 0
    for v in tq.values:
        if not isinstance(v, Variable) or not isinstance(v.data, QTensor) \
                or v.data.bit_width > 8:
            continue
        want = s["jdata"][v.name].astype(np.int64)
        got = v.data.data.numpy().astype(np.int64)
        assert want.shape == got.shape, v.name
        diff = np.abs(want - got)
        assert diff.max(initial=0) <= 1, v.name
        flips += int((diff > 0).sum())
        total += want.size
        if v.name in att_names:
            att_flips += int((diff > 0).sum())
            att_total += want.size
    print(f"seq {seq}: int8 intermediates differing by 1 LSB: {flips} of "
          f"{total}; attention outputs {att_flips} of {att_total}")
    assert att_total == B_LM * seq * CFG["n_embd"] * CFG["n_layer"]
    assert flips <= 0.001 * total
    jy = s["jy"]
    atol = 1e-4 if flips == 0 else 1e-2 * float(np.abs(jy).max())
    np.testing.assert_allclose(fused, jy, rtol=0, atol=atol)

    with TC.low_precision_floats():
        bf = tq([x])[0]
    assert bf.dtype == np.float32 and np.isfinite(bf).all()
    err = float(np.abs(bf - fused).max())
    print(f"seq {seq}: bf16 max|bf16 - f32| {err:.3g} of "
          f"{np.abs(fused).max():.3g}; argmax agreement "
          f"{(bf.argmax(-1) == fused.argmax(-1)).mean():.3f}")
    assert err <= 0.05 * float(np.abs(fused).max())


def test_score_bias_is_recorded_not_fused(lm):
    """A general additive bias before the Softmax (here each mask
    initializer replaced by one random [1, 1, N, N] bias, in JAX's graph and
    the port's) fuses as the 4th FusedAttentionHS input: the optimize()
    report equals JAX's, and the fused forward equals the unfused one bit
    for bit."""
    from numpy_quant_tpu import onnx as J_ONNX
    s = _setup(lm, 16)
    rng = np.random.default_rng(4)
    bias = rng.normal(size=(1, 1, 16, 16)).astype(np.float32)

    def biased(proto, onnx):
        inits = proto.graph.initializer
        for idx, t in enumerate(inits):
            if t.name.endswith("causal_mask"):
                inits[idx] = onnx.from_array(bias, t.name)
        return proto

    with jax.enable_x64(False):
        jm = nq.Model.from_onnx(biased(
            JG.gpt_causal_lm(module=lm["hf"], batch_size=B_LM, seq_len=16),
            J_ONNX))
        stats = jm.calibration_stats([s["calib"]])
        jrep = jm.quantize(bit_width=8, stats=stats).optimize()
    proto = biased(TG.gpt_causal_lm(lm["weights"], CFG, batch_size=B_LM,
                                    seq_len=16), T_ONNX)
    tq = Model.from_onnx(proto, device="cpu").quantize(bit_width=8,
                                                       stats=stats)
    unfused = tq([s["x"]])[0]
    rep = tq.optimize()
    assert rep == {key: jrep[key] for key in rep}
    assert rep["fuse_attention"] == CFG["n_layer"]
    assert rep["fusion_failures"] == []
    fnodes = [n for n in tq.nodes if n.op == "FusedAttentionHS"]
    assert len(fnodes) == CFG["n_layer"]
    assert all(len(n.inputs) == 4 and "causal_mask_val" not in n.attrs
               for n in fnodes)
    np.testing.assert_array_equal(tq([s["x"]])[0], unfused)
