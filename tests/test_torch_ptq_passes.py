"""The port's float-model reparameterizations held against the JAX
package's, in TPU-mode numerics (x64 off): ``smooth_outliers``
(LayerNorm on the small trained ViT, the decomposed RMSNorm on a tiny
LLaMA), ``awq_scale_weights`` (the trained ViT, grouped and per-tensor),
``rotate_vo`` (the ViT's dedicated v projection, the modular-sum GPT's
merged QKV) and ``equalize`` (a ReLU MLP, a Conv/ReLU/Conv chain, a tiny
T5's ReLU feed-forwards).

Each pass counts what JAX counts and rewrites the float constants to
within 1e-6 relative of JAX's (rotate and equalize read no activations
and give the same bytes); AWQ picks JAX's alphas on the same
activations (on its own, one group may part by one grid step, printed);
every rewrite is exact, so the float outputs stay within 1e-4 of the
unrewritten model's.
Where JAX declines (a consumer that cannot absorb the scale, a norm
output that is a graph output, a link that is not positively
homogeneous) the port declines too. Every pass drops the model's
captured forwards."""
import jax
import numpy as np
import pytest
import torch
from transformers import (LlamaConfig, LlamaForCausalLM,
                          T5ForConditionalGeneration)

import numpy_quant_tpu as nq
from numpy_quant_tpu import onnx as J_ONNX
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.models import fixtures as JF
from numpy_quant_tpu.models import llama as JL
from numpy_quant_tpu.models import modsum_fixture as JM
from numpy_quant_tpu.models import t5 as JT
from numpy_quant_tpu.tensor import FTensor as JFTensor
from numpy_quant_tpu.utils.parity import record_all_values
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import awq as TA
from numpy_quant_tpu_torch import onnx as T_ONNX
from numpy_quant_tpu_torch.graph import Constant
from numpy_quant_tpu_torch.models import fixtures as TF
from numpy_quant_tpu_torch.models import llama as TL
from numpy_quant_tpu_torch.models import modsum_fixture as TM
from numpy_quant_tpu_torch.models import t5 as TT
from numpy_quant_tpu_torch.quantization import weight_only_scales
from .torch_parity import assert_mapped_xla_cpu_host
from numpy_quant_tpu_torch.tensor import FTensor

LLAMA_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=64,
                 rms_norm_eps=1e-5, rope_theta=10000.0,
                 initializer_range=0.02, tie_word_embeddings=False)
RNG = np.random.default_rng(41)


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _jconsts(m) -> dict:
    return {v.name: np.asarray(v.data.data, np.float32) for v in m.values
            if isinstance(v, JConstant) and isinstance(v.data, JFTensor)}


def _tconsts(m) -> dict:
    return {v.name: v.data.data.numpy().copy() for v in m.values
            if isinstance(v, Constant) and isinstance(v.data, FTensor)}


def _same_constants(tm, jm, rtol=1e-6) -> None:
    """Every float constant of the port within ``rtol`` of JAX's."""
    tc, jc = _tconsts(tm), _jconsts(jm)
    assert set(tc) == set(jc)
    for name, arr in jc.items():
        np.testing.assert_allclose(tc[name], arr, rtol=rtol,
                                   atol=rtol * float(np.abs(arr).max(
                                       initial=0.0)), err_msg=name)


def _changed(before: dict, after: dict) -> set:
    return {k for k in before if not np.array_equal(before[k], after[k])}


class _Pair:
    """One graph in both packages: ``jmake()``/``tmake()`` build fresh
    float models, ``inputs`` feed them."""

    def __init__(self, jproto, tproto, inputs):
        self.jproto, self.tproto, self.inputs = jproto, tproto, inputs

    def jmake(self):
        return nq.Model.from_onnx(self.jproto)

    def tmake(self):
        return Model.from_onnx(self.tproto, device="cpu")


def _vit() -> _Pair:
    x, _ = TF.make_batch(np.random.default_rng(7), 4)
    return _Pair(JF.trained_vit_onnx(batch_size=4),
                 TF.trained_vit_onnx(batch_size=4), [x])


def _llama() -> _Pair:
    w = TL.random_llama_weights(LLAMA_CFG, seed=0)
    hf = LlamaForCausalLM(LlamaConfig(**LLAMA_CFG,
                                      attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    jp = JL.llama_causal_lm(batch_size=2, seq_len=8, module=hf)
    ids = np.random.default_rng(3).integers(0, 128, size=(2, 8))
    return _Pair(jp, TL.llama_causal_lm(w, LLAMA_CFG, batch_size=2,
                                        seq_len=8), [jp._wte[ids]])


def _modsum() -> _Pair:
    tp = TM.trained_modsum_onnx(batch_size=4)
    seqs = TM.make_modsum_batch(np.random.default_rng(5), 4)
    return _Pair(JM.trained_modsum_onnx(batch_size=4), tp,
                 [np.take(tp._wte, seqs, axis=0).astype(np.float32)])


def _t5() -> _Pair:
    torch.manual_seed(0)
    hf = T5ForConditionalGeneration(JT.default_config(12)).eval()
    w = {k: v.detach().numpy().copy() for k, v in hf.state_dict().items()}
    cfg = {k: getattr(hf.config, k) for k in TT.T5_SMALL}
    jp = JT.t5_conditional_generation(batch_size=2, src_len=12, tgt_len=8,
                                      module=hf)
    rng = np.random.default_rng(12)
    x = [jp._wte[rng.integers(0, 96, size=(2, n))] for n in (12, 8)]
    return _Pair(jp, TT.t5_conditional_generation(w, cfg, batch_size=2,
                                                  src_len=12, tgt_len=8), x)


def _shared_proto(nodes, inits, x_shape, y_name="y"):
    """A float graph built once with the JAX package's helpers and read by
    both packages from its bytes."""
    g = J_ONNX.make_graph(
        nodes, "g",
        [J_ONNX.make_tensor_value_info("x", J_ONNX.TensorProto.FLOAT,
                                       list(x_shape))],
        [J_ONNX.make_tensor_value_info(y_name, J_ONNX.TensorProto.FLOAT,
                                       None)],
        initializer=[J_ONNX.from_array(a, n) for n, a in inits.items()])
    jp = J_ONNX.make_model(g)
    return jp, T_ONNX.load_from_string(jp.SerializeToString())


def _mlp(act="Relu") -> _Pair:
    """x -> MatMul(W1, wildly scaled channels) -> Add -> act -> MatMul."""
    k, h, n = 16, 24, 6
    W1 = RNG.normal(size=(k, h)).astype(np.float32)
    W1 *= np.logspace(-2, 2, h, dtype=np.float32)[None, :]
    b1 = RNG.normal(size=h).astype(np.float32) \
        * np.logspace(-2, 2, h, dtype=np.float32)
    W2 = RNG.normal(size=(h, n)).astype(np.float32)
    nodes = [J_ONNX.make_node("MatMul", ["x", "w1"], ["h0"], name="mm1"),
             J_ONNX.make_node("Add", ["h0", "b1"], ["h1"], name="add1"),
             J_ONNX.make_node(act, ["h1"], ["h2"], name="act"),
             J_ONNX.make_node("MatMul", ["h2", "w2"], ["y"], name="mm2")]
    jp, tp = _shared_proto(nodes, {"w1": W1, "b1": b1, "w2": W2}, (64, k))
    return _Pair(jp, tp, [RNG.normal(size=(64, k)).astype(np.float32)])


def _conv_chain() -> _Pair:
    """Conv -> Relu -> Conv with imbalanced output channels."""
    w1 = RNG.normal(size=(8, 3, 3, 3)).astype(np.float32) \
        * np.logspace(-1.5, 1.5, 8, dtype=np.float32)[:, None, None, None]
    b1 = RNG.normal(size=8).astype(np.float32)
    w2 = RNG.normal(size=(4, 8, 3, 3)).astype(np.float32)
    b2 = RNG.normal(size=4).astype(np.float32)
    nodes = [J_ONNX.make_node("Conv", ["x", "w1", "b1"], ["c1"], name="c1",
                              pads=[1, 1, 1, 1]),
             J_ONNX.make_node("Relu", ["c1"], ["r1"], name="r1"),
             J_ONNX.make_node("Conv", ["r1", "w2", "b2"], ["y"], name="c2",
                              pads=[1, 1, 1, 1])]
    jp, tp = _shared_proto(nodes, {"w1": w1, "b1": b1, "w2": w2, "b2": b2},
                           (2, 3, 8, 8))
    return _Pair(jp, tp, [RNG.normal(size=(2, 3, 8, 8)).astype(np.float32)])


def _ln_graph(form: str) -> _Pair:
    """LayerNormalization -> MatMul, with the LN output also a graph
    output ("exposed") or also read by an Add ("unabsorbable")."""
    k = 8
    g, b = np.ones(k, np.float32), np.zeros(k, np.float32)
    w = RNG.normal(size=(k, k)).astype(np.float32)
    nodes = [J_ONNX.make_node("LayerNormalization", ["x", "g", "b"], ["ln"],
                              name="ln", axis=-1),
             J_ONNX.make_node("MatMul", ["ln", "w"], ["mm"], name="mm")]
    if form == "unabsorbable":
        nodes.append(J_ONNX.make_node("Add", ["mm", "ln"], ["y"], name="add"))
        out = "y"
    else:
        out = "ln"
    jp, tp = _shared_proto(nodes, {"g": g, "b": b, "w": w}, (4, k), out)
    return _Pair(jp, tp, [RNG.normal(size=(4, k)).astype(np.float32) * 3])


def _check_rewrite(pair, run, exact_float=1e-4, rtol=1e-6):
    """Run ``run(model, inputs)`` on fresh models of both packages: equal
    results, constants within ``rtol``, the port's float outputs within
    ``exact_float`` of the unrewritten port model's. Returns (port
    result, names of the constants the pass changed)."""
    jm, tm = pair.jmake(), pair.tmake()
    before = _tconsts(tm)
    y0 = tm(pair.inputs)
    jr, tr = run(jm, pair.inputs), run(tm, pair.inputs)
    assert tr == jr, (tr, jr)
    _same_constants(tm, jm, rtol)
    y1 = tm(pair.inputs)
    for a, b in zip(y1, y0):
        np.testing.assert_allclose(a, b, rtol=exact_float,
                                   atol=exact_float * max(
                                       1.0, float(np.abs(b).max())))
    return tr, _changed(before, _tconsts(tm))


@pytest.mark.parametrize("net,groups", [("vit", 8), ("llama", 5)])
def test_smooth_outliers_matches_jax(net, groups):
    pair = _vit() if net == "vit" else _llama()
    n, changed = _check_rewrite(
        pair, lambda m, x: m.smooth_outliers(x, alpha=0.5))
    assert n == groups, n
    assert changed


AWQ_MODES = [(4, 32, True), (3, None, False)]


def _awq(bits, group, per_channel):
    return lambda m, x: m.awq_scale_weights(
        x, bit_width=bits, group_size=group, per_channel=per_channel,
        max_tokens=128)


@pytest.mark.parametrize("bits,group,per_channel", AWQ_MODES)
def test_awq_alphas_match_jax_on_jax_activations(bits, group, per_channel,
                                                 monkeypatch):
    """The search itself: fed JAX's recorded activations, the port picks
    JAX's alpha in every group and rewrites the constants as JAX does."""
    pair = _vit()
    jacts = record_all_values(pair.jmake(), pair.inputs)
    monkeypatch.setattr(TA, "record_values", lambda model, inputs, names: {
        n: torch.from_numpy(jacts[n]) for n in names})
    chosen, changed = _check_rewrite(pair, _awq(bits, group, per_channel))
    print(f"AWQ alphas W{bits} g={group}: {chosen}")
    assert len(chosen) == 8
    assert bool(changed) == any(a > 0 for a in chosen.values())


@pytest.mark.parametrize("bits,group,per_channel", AWQ_MODES)
def test_awq_on_port_activations(bits, group, per_channel):
    """On its own float forward, whose attention dots, softmax and erf
    replay XLA's CPU orders (ROADMAP queue 3 item 3), every group's alpha
    equals JAX's at W4 g=32 and W3. The rewrite stays exact."""
    assert_mapped_xla_cpu_host()
    pair = _vit()
    jm, tm = pair.jmake(), pair.tmake()
    y0 = tm(pair.inputs)[0]
    jr = _awq(bits, group, per_channel)(jm, pair.inputs)
    tr = _awq(bits, group, per_channel)(tm, pair.inputs)
    assert set(tr) == set(jr)
    parted = {k: (tr[k], jr[k]) for k in jr if tr[k] != jr[k]}
    print(f"AWQ W{bits} g={group}: alphas parted from JAX's: {parted}")
    assert not parted
    np.testing.assert_allclose(tm(pair.inputs)[0], y0, rtol=1e-4,
                               atol=1e-4 * float(np.abs(y0).max()))


@pytest.mark.parametrize("net,count", [("vit", 4), ("modsum", 4)])
def test_rotate_vo_matches_jax(net, count):
    pair = _vit() if net == "vit" else _modsum()
    n, changed = _check_rewrite(pair, lambda m, x: m.rotate_vo(seed=3),
                                rtol=0.0)
    assert n == count, n
    assert len(changed) >= 2 * count


@pytest.mark.parametrize("net,pairs", [("mlp", 1), ("conv", 1), ("t5", 4)])
def test_equalize_matches_jax(net, pairs):
    pair = {"mlp": _mlp, "conv": _conv_chain, "t5": _t5}[net]()
    n, changed = _check_rewrite(pair, lambda m, x: m.equalize(), rtol=0.0)
    assert n == pairs, n
    assert changed


@pytest.mark.parametrize("case", ["ln_exposed", "ln_unabsorbable",
                                  "equalize_sigmoid"])
def test_declined_like_jax(case):
    if case == "equalize_sigmoid":
        pair = _mlp("Sigmoid")
        run = lambda m, x: m.equalize()  # noqa: E731
    else:
        pair = _ln_graph(case.removeprefix("ln_"))
        run = lambda m, x: (m.smooth_outliers(x),  # noqa: E731
                            m.awq_scale_weights(x))
    n, changed = _check_rewrite(pair, run, rtol=0.0)
    assert not changed
    assert n in (0, (0, {}))


@pytest.mark.parametrize("name", ["smooth_outliers", "awq_scale_weights",
                                  "rotate_vo", "equalize"])
def test_pass_drops_captured_forwards(name):
    pair = _vit() if name != "equalize" else _mlp()
    tm = pair.tmake()
    tm._graphs["entry"] = object()
    args = () if name in ("rotate_vo", "equalize") else (pair.inputs,)
    getattr(tm, name)(*args)
    assert tm._graphs == {}


@pytest.mark.parametrize("bits,group,per_channel,groupable",
                         [(4, 32, True, True), (4, 32, True, False),
                          (3, None, True, False), (3, None, False, False),
                          (2, 16, False, True), (8, 48, True, True)])
def test_awq_fake_quant_is_quantize_weights_grid(bits, group, per_channel,
                                                 groupable):
    """The search's device fake-quant uses quantize_weights' own scale
    choice (quantization.weight_only_scales) bit for bit."""
    W = (RNG.standard_t(3, size=(96, 40)) * 0.05).astype(np.float32)
    scale, _ = weight_only_scales(W, bits, 1, per_channel=per_channel,
                                  group_size=group, groupable=groupable)
    lo, hi = -2.0 ** (bits - 1), 2.0 ** (bits - 1) - 1
    want = (np.rint(np.clip(W / scale, lo, hi)) * scale).astype(np.float32)
    got = TA._fake_quant_kn(torch.from_numpy(W), bits, per_channel, group,
                            groupable).numpy()
    np.testing.assert_array_equal(got, want)
