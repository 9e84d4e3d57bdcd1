"""The port's deployment artifacts (``utils/aot.py``) and the hand kernels
as ``torch.library`` custom ops, held against the JAX package's
``utils/aot.py`` in TPU-mode numerics (x64 off), on the CPU.

* A small ViT (1 image row of 12 px, 4 px patches, hidden 16, 2 heads, 2
  layers, MLP 24: JAX's ``vit(1, 12, 4, 24, 16, 2, 2, 4)`` shape, here
  with a 4-label head and 2 images), int8, optimized and packed, with
  JAX's payloads and params carried into the port
  (``convert.load_jax_params``), and its float model: the port's loaded
  artifact equals the port's live forward bit for bit; the port's integer
  intermediates equal JAX's, and its labels equal those of JAX's loaded
  artifact, whose logits the port's meet within 1e-2 * max|logit| (the
  bound tests/test_torch_serialization.py states for the two packages'
  int8 logits; float logits within 1e-4 * max, f32 sums in another
  order).
* ``load_compiled`` refuses a file that is no artifact, JAX's own
  ``nq_aot_v1`` artifact and a decode-loop artifact (ValueError), and
  loads in a fresh process given only the path.
* The copy-task fixture's decode loop (``trained_gpt_decode_onnx``,
  batch 4, greedy): the loaded loop's tokens equal JAX's loaded loop's
  and the port's ``generate_kv``'s on two prompt batches, with copy
  accuracy 1.0; sampled with a seeded generator, equal to generate_kv
  with the same seed. A 2-layer narrow TinyLlama step, int8, fused, with
  an int8 cache and RoPE: equal to generate_kv.
* ``torch.library.opcheck`` of each of the nine ops at one small shape
  per form, each op's arguments as its public wrapper hands them over.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from transformers import ViTConfig
from transformers.models.vit.modeling_vit import ViTForImageClassification

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import text_fixture as JTF
from numpy_quant_tpu.models import vit as JV
from numpy_quant_tpu.utils import aot as JA
from numpy_quant_tpu.utils import generate_kv as j_generate_kv
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import config as TC
from numpy_quant_tpu_torch import kernels as K
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.kernels.pack import pack_bitplanes, pack_splitk
from numpy_quant_tpu_torch.models import llama as TL
from numpy_quant_tpu_torch.models import text_fixture as TF
from numpy_quant_tpu_torch.models import vit as TV
from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                         load_compiled, load_decode_loop,
                                         merge_calibration_stats,
                                         save_compiled, save_decode_loop)
from .torch_parity import assert_integers_equal, jax_qvalues, jax_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=24, image_size=12, patch_size=4, num_labels=4)
LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=1024,
             rms_norm_eps=1e-5, rope_theta=10000.0, initializer_range=0.02,
             tie_word_embeddings=False)


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def vit(tmp_path_factory):
    """(port QModel, port float Model, JAX QModel, JAX float Model, x,
    artifact dir): the int8 pair with JAX's payloads in the port, both
    optimized and packed."""
    weights = TV.random_vit_weights(CFG, seed=4)
    hf = ViTForImageClassification(
        ViTConfig(**CFG, attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    x = np.random.default_rng(7).normal(size=(2, 3, 12, 12)) \
        .astype(np.float32)
    with jax.enable_x64(False):
        jm = nq.Model.from_onnx(JV.vit_image_classifier(module=hf))
        stats = jm.calibration_stats([x])
        jq = jm.quantize(stats=stats, bit_width=8)
    tm = Model.from_onnx(TV.vit_image_classifier(weights, CFG), device="cpu")
    tq = tm.quantize(stats=stats, bit_width=8)
    load_jax_params(tq, jax_state(jq))
    jq.optimize()
    tq.optimize()
    assert jq.pack_weights() == tq.pack_weights() > 0
    return dict(tq=tq, tm=tm, jq=jq, jm=jm, x=x,
                dir=tmp_path_factory.mktemp("aot"))


@pytest.mark.parametrize("kind", ["int8", "float"])
def test_loaded_forward_equals_live_and_jax(vit, kind):
    x, d = vit["x"], vit["dir"]
    port = vit["tq" if kind == "int8" else "tm"]
    jmodel = vit["jq" if kind == "int8" else "jm"]
    path = str(d / f"vit_{kind}.pt2")
    save_compiled(port, path, [x])
    got = load_compiled(path)([x])
    want = port([x])
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])

    with jax.enable_x64(False):
        jpath = str(d / f"vit_{kind}_jax.npz")
        JA.save_compiled(jmodel, jpath, [x])
        jgot = np.asarray(JA.load_compiled(jpath)([x])[0])
    np.testing.assert_array_equal(got[0].argmax(-1), jgot.argmax(-1))
    rel = 1e-2 if kind == "int8" else 1e-4
    np.testing.assert_allclose(got[0], jgot, rtol=0,
                               atol=rel * float(np.abs(jgot).max()))
    if kind == "int8":
        port([x], record=True)
        assert assert_integers_equal(port, jax_qvalues(jmodel, [x])) > 10


def test_artifact_lifts_payloads_as_buffers(vit):
    """The payloads ride as the program's buffers, one per entry of
    _device_params (int8 storage, column sums, packed planes) and float
    constant, none folded in."""
    path = str(vit["dir"] / "vit_int8_sig.pt2")
    save_compiled(vit["tq"], path, [vit["x"]])
    ep = torch.export.load(path)
    buffers = [s for s in ep.graph_signature.input_specs
               if s.kind.name == "BUFFER"]
    from numpy_quant_tpu_torch.utils.aot import _payloads
    payloads = _payloads(vit["tq"])
    assert len(buffers) == len(payloads)
    packed = [n for n in payloads if n.endswith(".planes")]
    assert len(packed) == 12  # 6 MatMul weights per layer
    ops = {str(n.target) for n in ep.graph.nodes
           if n.op == "call_function"}
    assert {"nqt.quantize.default", "nqt.dequantize.default",
            "nqt.fused_attention_hs.default"} <= ops


def test_load_compiled_refusals(vit, tmp_path):
    x = vit["x"]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, a=np.zeros(3))
    with pytest.raises(ValueError, match="not a nqt_aot_v1"):
        load_compiled(bad)
    text = tmp_path / "text.pt2"
    text.write_text("no archive")
    with pytest.raises(ValueError, match="not a nqt_aot_v1"):
        load_compiled(str(text))
    jpath = str(tmp_path / "jax.npz")
    with jax.enable_x64(False):
        JA.save_compiled(vit["jq"], jpath, [x])
    with pytest.raises(ValueError, match="JAX artifact"):
        load_compiled(jpath)
    proto = TF.trained_gpt_decode_onnx(batch_size=4)
    model = Model.from_onnx(proto, device="cpu")
    prompts, _ = TF.make_prompts(np.random.default_rng(9), 4)
    loop = str(tmp_path / "loop.pt2")
    save_decode_loop(model, loop, proto._wte, proto._wpe,
                     prompts.astype(np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="decode"):
        load_compiled(loop)
    fwd = str(tmp_path / "fwd.pt2")
    save_compiled(vit["tm"], fwd, [x])
    with pytest.raises(ValueError, match="forward"):
        load_decode_loop(fwd)


def test_devices_other_than_the_models_are_refused(vit, tmp_path):
    path = str(tmp_path / "v.pt2")
    with pytest.raises(ValueError, match="traced on"):
        save_compiled(vit["tm"], path, [vit["x"]], devices=("cpu", "cuda"))
    save_compiled(vit["tm"], path, [vit["x"]], devices=("cpu",))
    with pytest.raises(ValueError, match="cannot serve"):
        load_compiled(path, device="cuda")


def test_load_in_a_fresh_process(vit):
    d = vit["dir"]
    path = str(d / "vit_fresh.pt2")
    save_compiled(vit["tq"], path, [vit["x"]])
    np.save(d / "x.npy", vit["x"])
    code = ("import sys, numpy as np\n"
            "from numpy_quant_tpu_torch.utils import load_compiled\n"
            "fn = load_compiled(sys.argv[1])\n"
            "np.save(sys.argv[3], fn([np.load(sys.argv[2])])[0])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code, path, str(d / "x.npy"),
                    str(d / "y.npy")], check=True, env=env, cwd=str(d),
                   timeout=300)
    np.testing.assert_array_equal(np.load(d / "y.npy"),
                                  vit["tq"]([vit["x"]])[0])


@pytest.fixture(scope="module")
def copy_task(tmp_path_factory):
    proto = TF.trained_gpt_decode_onnx(batch_size=4)
    model = Model.from_onnx(proto, device="cpu")
    d = tmp_path_factory.mktemp("loop")
    prompts = {seed: TF.make_prompts(np.random.default_rng(seed), 4)
               for seed in (9, 10)}
    greedy = str(d / "greedy.pt2")
    save_decode_loop(model, greedy, proto._wte, proto._wpe,
                     prompts[9][0].astype(np.int32),
                     max_new_tokens=TF.COPY_LEN)
    return dict(proto=proto, model=model, dir=d, prompts=prompts,
                greedy=load_decode_loop(greedy))


@pytest.mark.parametrize("seed", [9, 10])
def test_copy_loop_equals_jax_and_generate_kv(copy_task, seed):
    proto, model = copy_task["proto"], copy_task["model"]
    prompts, expected = copy_task["prompts"][seed]
    prompts = prompts.astype(np.int32)
    got = copy_task["greedy"](prompts)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, generate_kv(model, prompts, proto._wte, proto._wpe,
                         max_new_tokens=TF.COPY_LEN))
    assert TF.copy_accuracy(got[:, TF.COPY_LEN + 1:], expected) == 1.0
    with jax.enable_x64(False):
        jproto = JTF.trained_gpt_decode_onnx(batch_size=4)
        jmodel = nq.Model.from_onnx(jproto)
        jpath = str(copy_task["dir"] / f"jax_{seed}.npz")
        JA.save_decode_loop(jmodel, jpath, jproto._wte, jproto._wpe,
                            prompts, max_new_tokens=TF.COPY_LEN)
        jgot = np.asarray(JA.load_decode_loop(jpath)(prompts))
        np.testing.assert_array_equal(
            jgot, np.asarray(j_generate_kv(jmodel, prompts, jproto._wte,
                                           jproto._wpe, TF.COPY_LEN)))
    np.testing.assert_array_equal(got, jgot)


def test_sampled_loop_equals_generate_kv_with_the_same_seed(copy_task):
    proto, model = copy_task["proto"], copy_task["model"]
    prompts = copy_task["prompts"][9][0].astype(np.int32)
    kw = dict(temperature=0.8, top_k=5)
    path = str(copy_task["dir"] / "sampled.pt2")
    save_decode_loop(model, path, proto._wte, proto._wpe, prompts,
                     max_new_tokens=TF.COPY_LEN, **kw)
    fn = load_decode_loop(path)
    want = generate_kv(model, prompts, proto._wte, proto._wpe, TF.COPY_LEN,
                       generator=torch.Generator().manual_seed(5), **kw)
    np.testing.assert_array_equal(
        fn(prompts, generator=torch.Generator().manual_seed(5)), want)
    np.testing.assert_array_equal(
        fn(prompts), generate_kv(model, prompts, proto._wte, proto._wpe,
                                 TF.COPY_LEN, **kw))


def test_decode_loop_refusals(copy_task, tmp_path):
    proto, model = copy_task["proto"], copy_task["model"]
    prompts = copy_task["prompts"][9][0].astype(np.int32)
    path = str(tmp_path / "x.pt2")
    with pytest.raises(ValueError, match="memory"):
        save_decode_loop(model, path, proto._wte, proto._wpe, prompts, 2,
                         memory=np.zeros((4, 3, 8), np.float32))
    with pytest.raises(NotImplementedError):
        save_decode_loop(model, path, proto._wte, proto._wpe, prompts, 2,
                         key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="shape"):
        copy_task["greedy"](prompts[:2])


def test_int8_llama_loop_with_rope_and_int8_cache(tmp_path):
    w = TL.random_llama_weights(LLAMA, seed=0)
    proto = TL.llama_decode_step(w, LLAMA, batch_size=2, max_len=16)
    model = Model.from_onnx(proto, device="cpu")
    prompt = np.random.default_rng(2).integers(
        0, LLAMA["vocab_size"], size=(2, 6)).astype(np.int32)
    rope = proto._rope_tables
    batches = decode_calibration(model, prompt, proto._wte, None, rope=rope)
    q = model.quantize(stats=merge_calibration_stats(
        *[model.calibration_stats(b) for b in batches]), bit_width=8)
    assert q.optimize()["fuse_decode_attention"] == 2
    kw = dict(rope=rope, kv_cache_dtype="int8")
    path = str(tmp_path / "llama.pt2")
    save_decode_loop(q, path, proto._wte, None, prompt, 8, **kw)
    np.testing.assert_array_equal(
        load_decode_loop(path)(prompt),
        generate_kv(q, prompt, proto._wte, None, 8, **kw))


def test_weight_only_loop_through_the_packed_kernel_op(copy_task, tmp_path):
    """A float model with W4 g=16 weights (weight-only ``splitk_wo_matmul``
    under ``packed_execution="kernel"``) and a repetition penalty."""
    proto = TF.trained_gpt_decode_onnx(batch_size=4)
    model = Model.from_onnx(proto, device="cpu")
    assert model.quantize_weights(bit_width=4, group_size=16) > 0
    prompts = copy_task["prompts"][10][0].astype(np.int32)
    path = str(tmp_path / "w4.pt2")
    saved = TC.packed_execution
    TC.packed_execution = "kernel"
    try:
        save_decode_loop(model, path, proto._wte, proto._wpe, prompts,
                         TF.COPY_LEN, repetition_penalty=1.3)
        want = generate_kv(model, prompts, proto._wte, proto._wpe,
                           TF.COPY_LEN, repetition_penalty=1.3)
    finally:
        TC.packed_execution = saved
    ep = torch.export.load(path)
    # the loop body is a submodule of the program
    assert "nqt.splitk_wo_matmul.default" in {
        str(n.target) for m in ep.graph_module.modules()
        for n in m.graph.nodes}
    np.testing.assert_array_equal(load_decode_loop(path)(prompts), want)


# -- the custom ops ----------------------------------------------------------

class _OpCalls(TorchDispatchMode):
    """Records the nqt:: op calls made inside."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "nqt":
            self.calls.append((func, args, kwargs))
        return func(*args, **kwargs)


def _i8(rng, *shape):
    return torch.from_numpy(rng.integers(-128, 128, size=shape)
                            .astype(np.int8))


def _attention(rng, fn, **kw):
    xq, xk, xv = (_i8(rng, 2, 8, 32) for _ in range(3))
    base = dict(num_heads=2, scaling=0.25, sq=0.02, zq=3, sk=0.03, zk=-2,
                sv=0.05, zv=1, sp=1 / 255, zp_p=-128)
    return lambda: fn(xq, xk, xv, **dict(base, **kw))


def _plain(rng, **kw):
    q, kt, v = _i8(rng, 4, 8, 16), _i8(rng, 4, 16, 8), _i8(rng, 4, 8, 16)
    base = dict(scaling=0.25, sq=0.02, zq=3, sk=0.03, zk=-2, sv=0.05, zv=1,
                sp=1 / 255, zp_p=-128)
    return lambda: K.fused_attention(q, kt, v, **dict(base, **kw))


def _packed(rng, layout, bits, **kw):
    w = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), size=(32, 16))
    if layout == "splitk":
        payload = torch.from_numpy(w.astype(np.int8) if bits == 8
                                   else pack_splitk(w, bits))
        fn = K.splitk_qmatmul
    else:
        payload = torch.from_numpy(pack_bitplanes(w, bits))
        fn = K.packed_qmatmul
    colsum = torch.from_numpy(w.sum(0, keepdims=True).astype(np.int32))
    base = dict(bits=bits, bit_width=8, x_scale=0.02, x_zp=3, w_scale=0.01)
    base.update(kw)
    x = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32)) \
        if base.get("quantize_x", True) else _i8(rng, 5, 32)
    return lambda: fn(x, payload, colsum, **base)


def _wo(rng, scale_kind, dtype):
    w = rng.integers(-8, 8, size=(32, 16))
    packed = torch.from_numpy(pack_splitk(w, 4))
    x = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32)) \
        .to(dtype)
    scale = {"tensor": np.float32(0.01),
             "channel": rng.uniform(0.01, 0.02, (1, 16)).astype(np.float32),
             "group": rng.uniform(0.01, 0.02, (4, 16)).astype(np.float32)}
    return lambda: K.splitk_wo_matmul(x, packed, scale[scale_kind], bits=4)


def _cases():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    xt = x.t()  # dense, not contiguous
    qi = _i8(rng, 4, 6).to(torch.int32)
    rows = rng.uniform(0.01, 0.1, (1, 6)).astype(np.float32)
    zps = torch.from_numpy(rng.integers(-3, 4, (4, 1)).astype(np.int32))
    bias = torch.from_numpy(rng.normal(size=(2, 8, 8)).astype(np.float32))
    return {
        "quantize:int8": lambda: K.quantize(x, 8, 0.05, 3, torch.int8),
        "quantize:int32_channel": lambda: K.quantize(x, 4, rows, None),
        "quantize:int64_zp_tensor": lambda: K.quantize(
            x.to(torch.bfloat16), 12, 0.01, zps.to(torch.int64),
            torch.int64),
        "quantize:transposed_zero_scale": lambda: K.quantize(
            xt, 8, 0.0, None),
        "dequantize:int32": lambda: K.dequantize(qi, 0.05, 3),
        "dequantize:int8_bf16": lambda: K.dequantize(
            qi.to(torch.int8), rows, zps, torch.bfloat16),
        "dequantize:int64": lambda: K.dequantize(qi.to(torch.int64), 0.1,
                                                 None),
        "fake_quantize:int8": lambda: K.fake_quantize(x, 8, 0.05, 3),
        "fake_quantize:bf16_rows_int64": lambda: K.fake_quantize(
            x.to(torch.bfloat16)[:, :5], 12, rows[:, :5], zps.to(
                torch.int64), torch.int64),
        "fused_attention_hs:exact": _attention(rng, K.fused_attention_hs),
        "fused_attention_hs:fast_requant": _attention(
            rng, K.fused_attention_hs, fast=True, out_requant=(0.1, 2)),
        "fused_attention_hs:shift_causal": _attention(
            rng, K.fused_attention_hs, fast=True, score_max=4.0,
            causal_mask_val=-1e4),
        "fused_attention_hs:bias_tp": _attention(
            rng, K.fused_attention_hs, score_bias=bias, head_base=2,
            head_total=4),
        "fused_attention_hs_blockq:exact": _attention(
            rng, K.fused_attention_hs_blockq, block_q=4),
        "fused_attention_hs_blockq:window": _attention(
            rng, K.fused_attention_hs_blockq, block_q=4,
            causal_mask_val=-1e4, causal_window=3, out_requant=(0.1, None)),
        "fused_attention:exact": _plain(rng),
        "fused_attention:causal_requant": _plain(
            rng, causal_mask_val=-1e4, out_requant=(0.1, 2)),
        "fused_attention:tp": _plain(rng, num_heads=2, head_base=1,
                                     head_total=4),
        "splitk_qmatmul:8": _packed(rng, "splitk", 8),
        "splitk_qmatmul:4_requant": _packed(
            rng, "splitk", 4, out_requant=(0.1, 1, 8), bias=np.ones(16)),
        "splitk_qmatmul:2_int_x": _packed(
            rng, "splitk", 2, quantize_x=False, x_zp=None),
        "packed_qmatmul:3": _packed(rng, "bitplanes", 3),
        "packed_qmatmul:5_channel": _packed(
            rng, "bitplanes", 5, w_scale=None,
            w_scale_vec=np.full((1, 16), 0.01, np.float32)),
        "splitk_wo_matmul:tensor": _wo(rng, "tensor", torch.float32),
        "splitk_wo_matmul:channel_bf16": _wo(rng, "channel", torch.bfloat16),
        "splitk_wo_matmul:group": _wo(rng, "group", torch.float32),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_custom_op_passes_opcheck(case):
    """Each op as its wrapper calls it: one nqt:: call, whose CPU kernel
    is the plain version, and which torch.library.opcheck passes (schema,
    autograd registration, fake tensor against real, AOT dispatch)."""
    run = _cases()[case]
    with _OpCalls() as rec:
        out = run()
    assert len(rec.calls) == 1
    op, args, kwargs = rec.calls[0]
    assert op.name().split("::")[1].split(".")[0] == case.split(":")[0]
    np.testing.assert_array_equal(
        op(*args, **kwargs).float().numpy(), out.float().numpy())
    torch.library.opcheck(op, args, kwargs)


def test_every_counted_kernel_is_an_op():
    names = {fn.__name__ for fn in K.COUNTED}
    assert names == {c.split(":")[0] for c in _cases()}
    for name in names:
        op = getattr(torch.ops.nqt, name).default
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            op.name(), "CUDA")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            op.name(), "CPU")
