"""The port's decode-attention fusion (``passes/decode_attention.py``,
``Model.fuse_decode_attention``, ``optimize()``) and its ``DecodeAttention``
op (``ops/registry.py``) held against the JAX package on the tiny LLaMA
step (2 layers, hidden 64, 4 heads, 2 KV heads, head_dim 16, vocab 128)
and a small GPT-2 step (2 layers, n_embd 64, 4 heads, vocab 96), in
TPU-mode numerics (x64 off), with JAX's decode-calibration stats.

Tolerances: the fused count and every attribute equal JAX's (the scale
constant, the epilogue, the recorded qparams as float32). Float models:
fused tokens equal unfused ones. Quantized models: one fused step's
outputs lie within rtol=1e-5, atol=1e-5 of the unfused step's (JAX's own
bound: the dots run in float), fused tokens equal unfused ones with float
and int8 caches and equal JAX's fused tokens. The op alone equals JAX's op
within 1e-5 * max|out| on random inputs, an accumulator operand included,
which it narrows as the unfused executor does (requantize) bit for bit.
A chain whose q carries per-head (non-scalar) qparams: JAX fuses it and
drops q's quantize step; the port declines it and records why.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import GPT2Config, LlamaConfig
from transformers.models.gpt2.modeling_gpt2 import GPT2LMHeadModel
from transformers.models.llama.modeling_llama import LlamaForCausalLM

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import gpt as JG
from numpy_quant_tpu.models import llama as JL
from numpy_quant_tpu.ops.registry import \
    onnx_operator_implementation as j_op
from numpy_quant_tpu.tensor import FTensor as JFTensor
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu.utils import merge_calibration_stats as j_merge
from numpy_quant_tpu_torch import Model, QuantizationParams
from numpy_quant_tpu_torch.models import gpt as TG
from numpy_quant_tpu_torch.models import llama as TL
from numpy_quant_tpu_torch.ops.registry import \
    onnx_operator_implementation as t_op
from numpy_quant_tpu_torch.tensor import FTensor, QTensor
from numpy_quant_tpu_torch.utils import generate_kv

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=1024,
             rms_norm_eps=1e-5, rope_theta=10000.0, initializer_range=0.02,
             tie_word_embeddings=False)
GPT = dict(vocab_size=96, n_positions=16, n_embd=64, n_layer=2, n_head=4)
LAYERS, HEADS = 2, 4
B, MAX_LEN, PROMPT, NEW = 2, 12, 5, 6


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _build(family):
    """(JAX step proto, port step proto, prompt, rope or None)."""
    if family == "llama":
        weights = TL.random_llama_weights(LLAMA, seed=1)
        hf = LlamaForCausalLM(LlamaConfig(**LLAMA,
                                          attn_implementation="eager"))
        hf.eval().load_state_dict({k: torch.from_numpy(v)
                                   for k, v in weights.items()})
        with jax.enable_x64(False):
            jp = JL.llama_decode_step(batch_size=B, max_len=MAX_LEN,
                                      module=hf)
        tp = TL.llama_decode_step(weights, LLAMA, batch_size=B,
                                  max_len=MAX_LEN)
        vocab, rope = LLAMA["vocab_size"], jp._rope_tables
    else:
        weights = TG.random_gpt2_weights(GPT, seed=1)
        hf = GPT2LMHeadModel(GPT2Config(**GPT, activation_function="gelu",
                                        attn_implementation="eager")).eval()
        hf.load_state_dict({k: torch.from_numpy(v)
                            for k, v in weights.items()})
        with jax.enable_x64(False):
            jp = JG.gpt_decode_step(module=hf, batch_size=B, max_len=MAX_LEN)
        tp = TG.gpt_decode_step(weights, GPT, batch_size=B, max_len=MAX_LEN)
        vocab, rope = GPT["vocab_size"], None
    prompt = np.random.default_rng(6).integers(
        0, vocab, size=(B, PROMPT)).astype(np.int32)
    return jp, tp, prompt, rope


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def step(request):
    jp, tp, prompt, rope = _build(request.param)
    wpe = getattr(jp, "_wpe", None)
    with jax.enable_x64(False):
        jm = nq.Model.from_onnx(jp)
        batches = JGEN.decode_calibration(jm, prompt, jp._wte, wpe,
                                          rope=rope)
        stats = j_merge(*[jm.calibration_stats(b) for b in batches])
        step_in = [np.array(a) for a in batches[-1]]
    return dict(family=request.param, jp=jp, tp=tp, prompt=prompt,
                rope=rope, wpe=wpe, stats=stats, step_in=step_in)


def _decode(model, s, cache=None):
    return generate_kv(model, s["prompt"], s["tp"]._wte,
                       getattr(s["tp"], "_wpe", None), NEW, rope=s["rope"],
                       kv_cache_dtype=cache)


def _jdecode(model, s, cache=None):
    with jax.enable_x64(False):
        return np.asarray(JGEN.generate_kv(
            model, s["prompt"], s["jp"]._wte, s["wpe"], NEW, rope=s["rope"],
            kv_cache_dtype=cache))


def _attrs(model):
    return {n.name: dict(n.attrs) for n in model.nodes
            if n.op == "DecodeAttention"}


def _same_attrs(got, want):
    assert set(got) == set(want) and len(got) == LAYERS
    for name, attrs in got.items():
        assert set(attrs) == set(want[name]), name
        for key, val in attrs.items():
            w = want[name][key]
            if key == "epilogue":
                assert len(val) == len(w)
                for (kind, v), (wkind, wv) in zip(val, w):
                    assert kind == wkind
                    assert np.float32(v) == np.float32(wv), (name, key)
            elif key.endswith("_qp"):
                assert np.float32(val[0]) == np.float32(w[0]), (name, key)
                assert val[1] == w[1], (name, key)
            else:
                assert val == w, (name, key)


def test_float_fusion_matches_jax(step):
    with jax.enable_x64(False):
        jm = nq.Model.from_onnx(step["jp"])
        jn = jm.fuse_decode_attention()
    base = Model.from_onnx(step["tp"], device="cpu")
    fused = Model.from_onnx(step["tp"], device="cpu")
    assert fused.fuse_decode_attention() == jn == LAYERS
    assert not any(n.op == "Softmax" for n in fused.nodes)
    _same_attrs(_attrs(fused), _attrs(jm))
    want = _decode(base, step)
    np.testing.assert_array_equal(_decode(fused, step), want)
    np.testing.assert_array_equal(want, _jdecode(jm, step))


def _quantized(step, fuse):
    with jax.enable_x64(False):
        jq = nq.Model.from_onnx(step["jp"]).quantize(stats=step["stats"],
                                                     bit_width=8)
        jrep = jq.optimize() if fuse else None
    tq = Model.from_onnx(step["tp"], device="cpu").quantize(
        stats=step["stats"], bit_width=8)
    trep = tq.optimize() if fuse else None
    return jq, jrep, tq, trep


def test_quantized_fusion_matches_jax(step):
    """optimize() on the int8 step: the same count and attributes as JAX;
    the Softmaxes it fused leave the failures list (JAX's report keeps
    fuse_attention's entries for them)."""
    jq, jrep, tq, trep = _quantized(step, fuse=True)
    assert trep["fuse_decode_attention"] == jrep["fuse_decode_attention"] \
        == LAYERS
    for key in ("fuse_attention", "fuse_gelu", "narrow_gather",
                "int8_dataflow"):
        assert trep[key] == jrep[key], key
    fused_sm = {f"Softmax{n.outputs[0].name.rsplit('/', 1)[0]}/probs"
                for n in tq.nodes if n.op == "DecodeAttention"}
    assert trep["fusion_failures"] == [
        f for f in jrep["fusion_failures"] if f[0] not in fused_sm] == []
    assert all(f[0] in fused_sm for f in jrep["fusion_failures"])
    _same_attrs(_attrs(tq), _attrs(jq))
    assert all(a["bit_width"] == 8 for a in _attrs(tq).values())


def test_quantized_fused_step_and_tokens(step):
    """One fused int8 step within JAX's bound of the unfused one; fused
    tokens equal unfused tokens (float and int8 caches) and JAX's fused
    tokens."""
    jq, _, tq, _ = _quantized(step, fuse=True)
    _, _, unfused, _ = _quantized(step, fuse=False)
    for f_, u_ in zip(tq(step["step_in"]), unfused(step["step_in"])):
        np.testing.assert_allclose(f_, u_, rtol=1e-5, atol=1e-5)
    want = _decode(unfused, step)
    for cache in (None, "int8"):
        got = _decode(tq, step, cache)
        np.testing.assert_array_equal(got, want, err_msg=str(cache))
        np.testing.assert_array_equal(got, _jdecode(jq, step, cache))
    np.testing.assert_array_equal(_decode(unfused, step, "int8"), want)


def test_per_head_qparams_are_declined(step):
    """q's calibrated params made per head ([1, H, 1, 1] scale): the
    unfused executor runs them, JAX fuses the chain (dropping q's quantize
    step), the port declines it with the reason in the report."""
    probe = Model.from_onnx(step["tp"], device="cpu")
    probe.fuse_decode_attention()
    q_names = [n.inputs[0].name for n in probe.nodes
               if n.op == "DecodeAttention"]
    assert len(q_names) == LAYERS
    jq, _, tq, _ = _quantized(step, fuse=False)
    _, _, unfused, _ = _quantized(step, fuse=False)
    for model in (jq, tq, unfused):
        for name in q_names:
            qp = model.quant_params[name]
            per_head = (np.float32(qp.scale)
                        * np.linspace(0.9, 1.1, HEADS, dtype=np.float32))
            model.quant_params[name] = type(qp)(
                per_head.reshape(1, HEADS, 1, 1), qp.zero_point)
    with jax.enable_x64(False):
        assert jq.optimize()["fuse_decode_attention"] == LAYERS
    rep = tq.optimize()
    assert rep["fuse_decode_attention"] == 0
    assert not any(n.op == "DecodeAttention" for n in tq.nodes)
    reasons = dict(rep["fusion_failures"])
    assert len(reasons) == LAYERS
    assert all("non-scalar qparams on q_qp" in r for r in reasons.values())
    np.testing.assert_array_equal(_decode(tq, step), _decode(unfused, step))
    assert isinstance(tq.quant_params[q_names[0]], QuantizationParams)


def _op_inputs(seed, acc_q):
    """Random DecodeAttention operands [B, H, ., D], both packages' forms:
    q float or a 32-bit accumulator, an int8 k cache, float k/v steps and
    v cache, the additive mask."""
    rng = np.random.default_rng(seed)
    d, n = 16, MAX_LEN
    kc = rng.integers(-128, 128, size=(B, HEADS, n, d)).astype(np.int32)
    arrays = dict(kh=rng.normal(size=(B, HEADS, 1, d)).astype(np.float32),
                  vc=rng.normal(size=(B, HEADS, n, d)).astype(np.float32),
                  vh=rng.normal(size=(B, HEADS, 1, d)).astype(np.float32),
                  mask=np.where(np.arange(n + 1) < 7, 0.0, -1e9).astype(
                      np.float32).reshape(1, 1, 1, n + 1))
    if acc_q:
        qd = rng.integers(-40000, 40000, size=(B, HEADS, 1, d)).astype(
            np.int32)
        q = ((qd, 32, np.float32(4.1e-5), 17), "acc")
    else:
        q = (rng.normal(size=(B, HEADS, 1, d)).astype(np.float32), "float")
    return q, (kc, 8, np.float32(0.021), -3), arrays


def _as_port(q, kc, arrays):
    (qv, kind) = q
    tq = QTensor(torch.from_numpy(qv[0]), qv[1], qv[2], qv[3]) \
        if kind == "acc" else FTensor(torch.from_numpy(qv))
    tk = QTensor(torch.from_numpy(kc[0]), kc[1], kc[2], kc[3])
    rest = [FTensor(torch.from_numpy(arrays[k]))
            for k in ("kh", "vc", "vh", "mask")]
    return [tq, tk, rest[0], rest[1], rest[2], rest[3]]


def _as_jax(q, kc, arrays):
    (qv, kind) = q
    jqv = JQTensor(jnp.asarray(qv[0]), qv[1], qv[2], qv[3]) \
        if kind == "acc" else JFTensor(jnp.asarray(qv))
    jk = JQTensor(jnp.asarray(kc[0]), kc[1], kc[2], kc[3])
    rest = [JFTensor(jnp.asarray(arrays[k]))
            for k in ("kh", "vc", "vh", "mask")]
    return [jqv, jk, rest[0], rest[1], rest[2], rest[3]]


OP_ATTRS = {"epilogue": (("mul", 0.25), ("add", 0)), "cache_len": MAX_LEN,
            "bit_width": 8, "q_qp": (0.0123, 5), "ktc_qp": (0.021, -3),
            "kts_qp": (0.0187, 2), "p_qp": (1.0 / 255.0, -128),
            "vc_qp": (0.0301, -9)}


@pytest.mark.parametrize("acc_q", [False, True], ids=["float_q", "acc_q"])
def test_op_matches_jax(acc_q):
    q, kc, arrays = _op_inputs(3, acc_q)
    got = t_op("DecodeAttention", _as_port(q, kc, arrays), OP_ATTRS)[0]
    with jax.enable_x64(False):
        want = np.asarray(j_op("DecodeAttention", _as_jax(q, kc, arrays),
                               OP_ATTRS)[0].data)
    got = got.data.numpy()
    assert got.shape == want.shape == (B, HEADS, 1, 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if acc_q:
        # the accumulator narrows as the unfused executor's requantize
        # does (QModel._narrow for a MatMul operand), bit for bit
        ins = _as_port(q, kc, arrays)
        s, z = OP_ATTRS["q_qp"]
        ins[0] = ins[0].requantize(8, np.float32(s), z)
        again = t_op("DecodeAttention", ins, OP_ATTRS)[0].data.numpy()
        np.testing.assert_array_equal(got, again)
