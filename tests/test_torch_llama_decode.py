"""The port's LLaMA decode forms (``models/llama.py::llama_decode_step``,
``llama_prefill``) and the RoPE/int8-cache decode loop
(``utils/generate.py::generate_kv(rope=, kv_cache_dtype=)``,
``decode_calibration``, ``utils/serialization.py::
merge_calibration_stats``) held against the JAX package on
``test_torch_llama.py``'s tiny config (2 layers, hidden 64, 4 heads, 2 KV
heads, head_dim 16, vocab 128), in TPU-mode numerics (x64 off). JAX builds
its graphs from a ``transformers`` ``LlamaForCausalLM`` loaded with the
port's ``random_llama_weights``; the port builds its own from the same
numpy weights.

Tolerances: the step and prefill graphs, their RoPE tables and embedding
tables are equal. Float step outputs, prefill logits and presents agree
within 1e-5 * max|value| (f32 sums in another order); the
``decode_calibration`` inputs are equal (x, mask, RoPE rows) or within
1e-5 * max (the caches, step outputs of each engine), and the merged
stats lie within 1e-5 relative. Float greedy tokens equal JAX's and the
full graph's. The int8 step, with JAX's stats: quantized constants and
qparams equal; int8 intermediates differ by at most 1 LSB on at most 0.1%
of entries (the count is printed), logits within 1e-4 when none differs,
else within 1e-2 * max|logit| (tests/test_torch_llama.py's bounds); int8
tokens equal JAX's, and int8-cache tokens equal float-cache tokens in
both packages. The int8 prefill's fused f32 forward equals its unfused
one bit for bit, with one FusedAttention per layer.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from transformers import LlamaConfig
from transformers.models.llama.modeling_llama import LlamaForCausalLM

import numpy_quant_tpu as nq
from numpy_quant_tpu import onnx as J_ONNX
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.graph import Variable as JVariable
from numpy_quant_tpu.models import llama as JL
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu.utils import merge_calibration_stats as j_merge
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import onnx as T_ONNX
from numpy_quant_tpu_torch.graph import Constant, Variable
from numpy_quant_tpu_torch.kernels import attention as TA
from numpy_quant_tpu_torch.models import llama as TL
from numpy_quant_tpu_torch.tensor import QTensor
from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                         merge_calibration_stats)

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=1024, rms_norm_eps=1e-5, rope_theta=10000.0,
           initializer_range=0.02, tie_word_embeddings=False)
LAYERS = CFG["num_hidden_layers"]
B, MAX_LEN, PROMPT, NEW = 2, 16, 6, 8
PREFILL = 8


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _rel_close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30))


@pytest.fixture(scope="module")
def dec():
    weights = TL.random_llama_weights(CFG, seed=0)
    hf = LlamaForCausalLM(LlamaConfig(**CFG, attn_implementation="eager"))
    hf.eval().load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    prompt = np.random.default_rng(2).integers(
        0, CFG["vocab_size"], size=(B, PROMPT)).astype(np.int32)
    with jax.enable_x64(False):
        jp = JL.llama_decode_step(batch_size=B, max_len=MAX_LEN, module=hf)
        jm = nq.Model.from_onnx(jp)
        rope = jp._rope_tables
        j_float = JGEN.generate_kv(jm, prompt, jp._wte, None, NEW, rope=rope)
        batches = JGEN.decode_calibration(jm, prompt, jp._wte, None,
                                          rope=rope)
        stats = j_merge(*[jm.calibration_stats(b) for b in batches])
        jq = jm.quantize(stats=stats, bit_width=8)
        j_int8 = JGEN.generate_kv(jq, prompt, jp._wte, None, NEW, rope=rope)
        j_int8_cache = JGEN.generate_kv(jq, prompt, jp._wte, None, NEW,
                                        rope=rope, kv_cache_dtype="int8")
        step_in = [np.array(a) for a in batches[-1]]
        jy = [np.asarray(o) for o in jq(step_in, record=True)]
        jdata = {v.name: np.asarray(v.data.data) for v in jq.values
                 if isinstance(v, JVariable) and isinstance(v.data, JQTensor)
                 and v.data.bit_width <= 8}
        jconsts = {v.name: (np.asarray(v.data.data),
                            np.asarray(v.data.scale, np.float32),
                            v.data.zero_point)
                   for v in jq.values if isinstance(v, JConstant)
                   and isinstance(v.data, JQTensor)}
        jqps = {n: (np.asarray(p.scale, np.float32), p.zero_point)
                for n, p in jq.quant_params.items()}
        j_float_step = [np.asarray(o) for o in jm(step_in)]
    return dict(weights=weights, hf=hf, prompt=prompt, jp=jp, rope=rope,
                j_float=np.asarray(j_float), batches=batches, stats=stats,
                j_int8=np.asarray(j_int8),
                j_int8_cache=np.asarray(j_int8_cache), step_in=step_in,
                jy=jy, jdata=jdata, jconsts=jconsts, jqps=jqps,
                j_float_step=j_float_step,
                tp=TL.llama_decode_step(weights, CFG, batch_size=B,
                                        max_len=MAX_LEN))


def _graph_signature(proto):
    g = proto.graph
    return ([(n.op_type, list(n.input), list(n.output)) for n in g.node],
            [i.name for i in g.input], [o.name for o in g.output],
            sorted(i.name for i in g.initializer))


@pytest.mark.parametrize("form", ["step", "prefill"])
def test_graphs_match_jax_node_for_node(dec, form):
    """The same nodes, value names, inputs, outputs and initializers, equal
    initializer payloads and equal tables riding on the proto."""
    if form == "step":
        jp, tp = dec["jp"], dec["tp"]
        rope_len = MAX_LEN
    else:
        with jax.enable_x64(False):
            jp = JL.llama_prefill(prefill_len=PREFILL, module=dec["hf"])
        tp = TL.llama_prefill(dec["weights"], CFG, prefill_len=PREFILL)
        rope_len = CFG["max_position_embeddings"]
    assert _graph_signature(tp) == _graph_signature(jp)
    jinit = {t.name: t for t in jp.graph.initializer}
    for t in tp.graph.initializer:
        np.testing.assert_array_equal(T_ONNX.to_array(t),
                                      J_ONNX.to_array(jinit[t.name]),
                                      err_msg=t.name)
    np.testing.assert_array_equal(tp._wte, jp._wte)
    assert tp._head_dim == jp._head_dim == 16
    for got, want in zip(tp._rope_tables, jp._rope_tables):
        assert got.shape == (1, 1, rope_len, 16)
        np.testing.assert_array_equal(got, want)


def test_float_step_matches_jax(dec):
    got = Model.from_onnx(dec["tp"], device="cpu")(dec["step_in"])
    assert len(got) == 1 + 2 * LAYERS
    assert got[0].shape == (B, 1, CFG["vocab_size"])
    assert got[1].shape == (B, CFG["num_key_value_heads"], 1, 16)
    for g_, w_ in zip(got, dec["j_float_step"]):
        _rel_close(g_, w_)


def test_decode_calibration_matches_jax(dec):
    """One input list per prompt step: x, the mask and the RoPE rows equal,
    the caches (each engine's own step outputs) within 1e-5 * max; the
    merged stats within 1e-5 relative of JAX's."""
    tm = Model.from_onnx(dec["tp"], device="cpu")
    batches = decode_calibration(tm, dec["prompt"], dec["tp"]._wte, None,
                                 rope=dec["tp"]._rope_tables)
    assert len(batches) == len(dec["batches"]) == PROMPT
    for got, want in zip(batches, dec["batches"]):
        assert len(got) == len(want) == 4 + 2 * LAYERS
        for i, (g_, w_) in enumerate(zip(got, want)):
            assert g_.dtype == torch.float32 and g_.device.type == "cpu"
            if i < 4:
                np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
            else:
                _rel_close(g_.numpy(), w_)
    stats = merge_calibration_stats(*[tm.calibration_stats(b)
                                      for b in batches])
    assert set(stats) == set(dec["stats"])
    for name, (mn, mx) in stats.items():
        jmn, jmx = dec["stats"][name]
        span = max(abs(float(jmn)), abs(float(jmx)), 1e-30)
        assert abs(float(mn) - float(jmn)) <= 1e-5 * span, name
        assert abs(float(mx) - float(jmx)) <= 1e-5 * span, name


def test_merge_calibration_stats_matches_jax():
    a = {"x": (np.float32(-1.0), np.float32(2.0)), "y": (0.5, 0.75)}
    b = {"x": (np.float32(-3.0), np.float32(1.0)), "z": (-2, 2)}
    got, want = merge_calibration_stats(a, b), j_merge(a, b)
    assert set(got) == set(want) == {"x", "y", "z"}
    for name in got:
        for g_, w_ in zip(got[name], want[name]):
            assert np.asarray(g_).dtype == np.asarray(w_).dtype
            assert g_ == w_


def _full_graph_greedy(weights, prompt, new):
    """Greedy decode through the port's full causal graph at the final
    length (the causal mask keeps the padded tail out)."""
    total = prompt.shape[1] + new
    proto = TL.llama_causal_lm(weights, CFG, batch_size=B, seq_len=total)
    tm, wte = Model.from_onnx(proto, device="cpu"), proto._wte
    ids = np.zeros((B, total), np.int64)
    ids[:, :prompt.shape[1]] = prompt
    for t in range(prompt.shape[1] - 1, total - 1):
        logits = tm([wte[ids]])[0]
        ids[:, t + 1] = logits[:, t].argmax(-1)
    return ids.astype(np.int32)


def test_float_greedy_matches_jax_and_full_graph(dec):
    tp = dec["tp"]
    got = generate_kv(Model.from_onnx(tp, device="cpu"), dec["prompt"],
                      tp._wte, None, NEW, rope=tp._rope_tables)
    assert got.dtype == np.int32 and got.shape == (B, PROMPT + NEW)
    np.testing.assert_array_equal(got[:, :PROMPT], dec["prompt"])
    np.testing.assert_array_equal(got, dec["j_float"])
    np.testing.assert_array_equal(
        got, _full_graph_greedy(dec["weights"], dec["prompt"], NEW))


def _port_int8(dec):
    tm = Model.from_onnx(dec["tp"], device="cpu")
    return tm.quantize(stats=dec["stats"], bit_width=8)


def test_int8_step_matches_jax(dec):
    """With JAX's stats: every quantized constant and qparam equal; one
    recorded step against JAX's int8 intermediates and logits."""
    tq = _port_int8(dec)
    consts = {v.name: v.data for v in tq.values
              if isinstance(v, Constant) and isinstance(v.data, QTensor)}
    assert set(consts) == set(dec["jconsts"])
    for name, t in consts.items():
        payload, scale, zp = dec["jconsts"][name]
        np.testing.assert_array_equal(t.data.numpy(), payload, err_msg=name)
        np.testing.assert_array_equal(np.asarray(t.scale), scale)
        assert t.zero_point == zp, name
    assert set(tq.quant_params) == set(dec["jqps"])
    for name, qp in tq.quant_params.items():
        scale, zp = dec["jqps"][name]
        np.testing.assert_array_equal(np.asarray(qp.scale), scale)
        assert qp.zero_point == zp, name

    got = tq(dec["step_in"], record=True)
    flips = total = 0
    for v in tq.values:
        if not isinstance(v, Variable) or not isinstance(v.data, QTensor) \
                or v.data.bit_width > 8:
            continue
        want = dec["jdata"][v.name].astype(np.int64)
        diff = np.abs(want - v.data.data.numpy().astype(np.int64))
        assert diff.max(initial=0) <= 1, v.name
        flips += int((diff > 0).sum())
        total += want.size
    print(f"int8 step intermediates differing by 1 LSB: {flips} of {total}")
    assert total > 0 and flips <= 0.001 * total
    for g_, w_ in zip(got, dec["jy"]):
        atol = 1e-4 if flips == 0 else 1e-2 * float(np.abs(w_).max())
        np.testing.assert_allclose(g_, w_, rtol=0, atol=atol)


@pytest.mark.parametrize("cache", [None, "int8"], ids=["float_cache",
                                                        "int8_cache"])
def test_int8_tokens_match_jax(dec, cache):
    """int8 tokens equal JAX's; int8-cache tokens equal the float-cache
    tokens in both packages (quantize is idempotent)."""
    tp = dec["tp"]
    got = generate_kv(_port_int8(dec), dec["prompt"], tp._wte, None, NEW,
                      rope=tp._rope_tables, kv_cache_dtype=cache)
    np.testing.assert_array_equal(got, dec["j_int8"])
    np.testing.assert_array_equal(dec["j_int8_cache"], dec["j_int8"])


def test_int8_cache_streams_int8_from_the_zero_point(dec):
    """The step model sees int8 caches: at step 0 every slot holds its cache
    input's zero point; after step t slot t holds the quantized present."""
    tq = _port_int8(dec)
    seen = []

    class Spy:
        def __getattr__(self, name):
            return getattr(tq, name)

        def __call__(self, inputs, **kw):
            seen.append([t.clone() for t in inputs[4:]])
            return tq(inputs, **kw)
    tp = dec["tp"]
    generate_kv(Spy(), dec["prompt"], tp._wte, None, 2, rope=tp._rope_tables,
                kv_cache_dtype="int8")
    for cache, v in zip(seen[0], tq.inputs[4:]):
        assert cache.dtype == torch.int8
        assert bool((cache == int(tq.quant_params[v.name].zero_point)).all())
    assert all(not torch.equal(a[:, :, 0], b[:, :, 0])
               for a, b in zip(seen[0], seen[1]))


def test_int8_cache_needs_a_quantized_model(dec):
    tp = dec["tp"]
    tm = Model.from_onnx(tp, device="cpu")
    with pytest.raises(ValueError, match="quantized step model"):
        generate_kv(tm, dec["prompt"], tp._wte, None, NEW,
                    rope=tp._rope_tables, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        generate_kv(_port_int8(dec), dec["prompt"], tp._wte, None, NEW,
                    rope=tp._rope_tables, kv_cache_dtype="int4")


def test_prefill_matches_jax_and_decode_calibration(dec):
    """The float prefill's logits and presents against JAX's, and its
    presents against the caches decode_calibration builds for the same
    prompt (one graph built for B=1 serves both rows)."""
    with jax.enable_x64(False):
        jp = JL.llama_prefill(prefill_len=PROMPT, module=dec["hf"])
        x = jp._wte[dec["prompt"]]
        want = [np.asarray(o) for o in nq.Model.from_onnx(jp)([x])]
    tp = TL.llama_prefill(dec["weights"], CFG, prefill_len=PROMPT)
    tm = Model.from_onnx(tp, device="cpu")
    got = tm([x])
    assert got[0].shape == (B, PROMPT, CFG["vocab_size"])
    assert got[1].shape == (B, CFG["num_key_value_heads"], PROMPT, 16)
    for g_, w_ in zip(got, want):
        _rel_close(g_, w_)
    step = Model.from_onnx(dec["tp"], device="cpu")
    batches = decode_calibration(step, dec["prompt"], dec["tp"]._wte, None,
                                 rope=dec["tp"]._rope_tables)
    res = step(batches[-1], as_numpy=False)
    for i in range(2 * LAYERS):
        cache = batches[-1][4 + i].clone()
        cache[:, :, PROMPT - 1:PROMPT] = res[1 + i]
        _rel_close(got[1 + i], cache[:, :, :PROMPT].numpy())


def test_int8_prefill_fused_equals_unfused(dec, monkeypatch):
    """int8 prefill: optimize() takes the plain fusion once per layer, and
    the fused f32 forward equals the unfused one bit for bit, its
    fused_attention calls on [B*heads, P, D] operands."""
    n = 16
    tp = TL.llama_prefill(dec["weights"], CFG, prefill_len=n)
    tm = Model.from_onnx(tp, device="cpu")
    rng = np.random.default_rng(9)
    calib = tp._wte[rng.integers(0, CFG["vocab_size"], size=(2, n))]
    x = tp._wte[rng.integers(0, CFG["vocab_size"], size=(1, n))]
    tq = tm.quantize(bit_width=8, stats=tm.calibration_stats([calib]))
    unfused = tq([x])
    rep = tq.optimize()
    assert rep["fuse_attention"] == LAYERS
    assert rep["fuse_decode_attention"] == 0 and rep["fusion_failures"] == []
    assert len(tq.fusion_report["plain_fusions"]) == LAYERS
    tiles = []
    plain = TA.fused_attention_reference
    monkeypatch.setattr(TA, "fused_attention_reference",
                        lambda *a, **k: tiles.append(a[0].shape)
                        or plain(*a, **k))
    fused = tq([x])
    assert tiles == [(CFG["num_attention_heads"], n, 16)] * LAYERS
    for f_, u_ in zip(fused, unfused):
        np.testing.assert_array_equal(f_, u_)
