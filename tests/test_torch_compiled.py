"""The captured forward's CPU side and the forward-reading tools, held
against the JAX package on small models (seeded numpy inputs):

* profile mode, ``Model.__call__(..., profile=True)``: the outputs of a
  plain call bit for bit, and JAX's op-type buckets (TinyqQuant and
  TinyqDequant in a QModel's);
* the graph cache: ``graph_key`` (a plain function) and the drop of every
  captured forward wherever a weight, the graph or its quantization
  changes; the capture and replay bookkeeping of ``Model._replay`` with a
  stand-in for the CUDA graph (inputs copied into the graph's buffers or
  read in place, launch counters, fresh outputs, the node a failed
  capture names);
* a capture-safety guard over one forward of each path the card captures
  (tiny ViT int8 optimize()d and packed under both packed executions and
  both float dtypes, the GPT-2 W4 decode step, the LLaMA int8 fused step
  with the int8 cache, T5): after one warm-up walk, no host read of a
  tensor value (``aten._local_scalar_dense``, ``aten.nonzero``, ...) and
  no host array turned into a tensor;
* the tools against JAX's: generate_kv with the caches as the graph's
  buffers, profile_results_plot, summarize (the same strings),
  record_all_values/compare_all_values (the same value names; float
  values within 1e-4 of max|value|, int8 ones within the int8 ViT
  tolerance of tests/test_torch_vit.py, 1e-2 of max|value|),
  quantization_report (the same rows in the same order, SQNR within
  1e-3 dB) and summarize_device_trace on a torch.profiler trace.

The CUDA graphs themselves run only on a card: ``chip_smoke.py`` phase 18.
"""
import contextlib
import importlib
import os

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import testgen
from numpy_quant_tpu.models import vit as JV
from numpy_quant_tpu.utils import analyzer as JA
from numpy_quant_tpu.utils import parity as JP
from numpy_quant_tpu.utils import profiling as JPROF
from numpy_quant_tpu.utils import summary as JS
from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch import intops
from numpy_quant_tpu_torch import kernels as TK
from numpy_quant_tpu_torch import model as TM
from numpy_quant_tpu_torch import onnx as T_ONNX
from numpy_quant_tpu_torch.models import gpt as TG
from numpy_quant_tpu_torch.models import llama as TL
from numpy_quant_tpu_torch.models import t5 as TT
from numpy_quant_tpu_torch.models import vit as TV
from numpy_quant_tpu_torch.quantization import quantize
from numpy_quant_tpu_torch.utils import (analyzer, merge_calibration_stats,
                                         parity, profiling, summary)

TGEN = importlib.import_module("numpy_quant_tpu_torch.utils.generate")
RNG = np.random.default_rng(0)
MLP = "numpy_quant_tpu/models/mlp.onnx"
VIT_CFG = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, image_size=32, patch_size=8,
               num_labels=10)
GPT_CFG = dict(vocab_size=96, n_positions=16, n_embd=64, n_layer=2,
               n_head=4)
LLAMA_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=1024,
                 rms_norm_eps=1e-5, rope_theta=10000.0,
                 initializer_range=0.02, tie_word_embeddings=False)
T5_CFG = dict(TT.T5_SMALL, vocab_size=64, d_model=32, d_kv=8, d_ff=64,
              num_layers=2, num_decoder_layers=2, num_heads=4)
B, MAX_LEN = 2, 16


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@contextlib.contextmanager
def packed_execution(mode):
    prev = TC.packed_execution
    TC.packed_execution = mode
    try:
        yield
    finally:
        TC.packed_execution = prev


def _port(jproto):
    """The JAX package's ONNX model as the port's, on the CPU."""
    return Model.from_onnx(T_ONNX.load_from_string(
        jproto.SerializeToString()), device="cpu")


# -- profile mode ---------------------------------------------------------

def test_profile_mode_matches_plain_call():
    """JAX's tests/test_inference.py::test_profile_mode_matches_jit_mode:
    the profiled outputs equal a plain call's, and the buckets are JAX's
    ({"Gemm"})."""
    jproto = testgen.gemm(3, 4, 2, random_seed=0)
    model = _port(jproto)
    x = RNG.normal(size=(3, 4)).astype(np.float32)
    fast = model([x])[0]
    eager, prof = model([x], profile=True)
    np.testing.assert_array_equal(fast, eager[0])
    assert set(prof) == {"Gemm"}
    assert prof["Gemm"] >= 0.0
    _, jprof = nq.Model.from_onnx(jproto)([x], profile=True)
    assert set(prof) == set(jprof)


def test_profile_mode_quantized_vit():
    """JAX's tests/test_vit.py::test_vit_quantized_small on a tiny ViT:
    the quantized profile has JAX's buckets, TinyqQuant among them, and
    its outputs equal a plain call's bit for bit."""
    jproto = JV.vit(2, 32, 8, 64, 48, 4)
    x = RNG.normal(size=(2, 3, 32, 32)).astype(np.float32)
    model = _port(jproto)
    qmodel = model.quantize([x], bit_width=8)
    outputs, prof = model([x], profile=True)
    qoutputs, qprof = qmodel([x], profile=True)
    np.testing.assert_array_equal(outputs[0], model([x])[0])
    np.testing.assert_array_equal(qoutputs[0], qmodel([x])[0])
    assert np.mean(np.abs(qoutputs[0] - outputs[0])) <= 0.1
    assert "TinyqQuant" in qprof and qprof["MatMul"] >= 0.0
    jm = nq.Model.from_onnx(jproto)
    _, jprof = jm([x], profile=True)
    _, jqprof = jm.quantize([x], bit_width=8)([x], profile=True)
    assert set(prof) == set(jprof)
    assert set(qprof) == set(jqprof)
    assert all(v >= 0.0 for v in qprof.values())


# -- the graph cache --------------------------------------------------------

def test_graph_key_is_the_signature():
    """One signature, one key: float/tensor inputs by shape and dtype,
    int64 inputs by value, then the float dtype, the packed execution and
    the device."""
    x = RNG.normal(size=(2, 3)).astype(np.float32)
    ints = np.array([4, 5], np.int64)
    key = TM.graph_key([x, ints], "cuda")
    assert TM.graph_key([x * 2, ints.copy()], "cuda") == key
    assert TM.graph_key([torch.from_numpy(x), ints], "cuda") == key
    others = [TM.graph_key([x, np.array([4, 6], np.int64)], "cuda"),
              TM.graph_key([x[:1], ints], "cuda"),
              TM.graph_key([x.astype(np.float64), ints], "cuda"),
              TM.graph_key([x, ints], "cpu")]
    with TC.low_precision_floats():
        others.append(TM.graph_key([x, ints], "cuda"))
    with packed_execution("kernel"):
        others.append(TM.graph_key([x, ints], "cuda"))
    assert len({key, *others}) == 1 + len(others)


def _vit_qmodel():
    weights = TV.random_vit_weights(VIT_CFG, seed=0)
    model = Model.from_onnx(TV.vit_image_classifier(weights, VIT_CFG),
                            device="cpu")
    x = RNG.normal(size=(2, 3, 32, 32)).astype(np.float32)
    return model, model.quantize([x], bit_width=8, quantize_conv=True), x


@pytest.mark.parametrize("change", [
    "invalidate_params", "pack_weights", "optimize", "fuse_attention",
    "fuse_decode_attention", "fuse_gelu", "narrow_gather",
    "int8_dataflow", "merge_parallel_matmuls"])
def test_graph_cache_drops_on_a_change(change):
    """Wherever JAX clears its jit cache (or the port drops its placed
    payloads) every captured forward goes: a replay would read weights or
    nodes that are gone."""
    _, qmodel, _ = _vit_qmodel()
    if change == "int8_dataflow":
        qmodel.fuse_attention()
    qmodel._graphs["entry"] = object()
    getattr(qmodel, change)()
    assert qmodel._graphs == {}


def test_graph_cache_drops_on_quantize_weights():
    model, _, _ = _vit_qmodel()
    model._graphs["entry"] = object()
    assert model.quantize_weights(bit_width=4) > 0
    assert model._graphs == {}


class _StandInGraph:
    """A CUDA graph's stand-in: replay walks the captured function again
    into the captured output tensors."""

    def __init__(self, fn, floats, outputs):
        self.fn, self.floats, self.outputs = fn, floats, outputs
        self.replays = 0

    def replay(self):
        self.replays += 1
        for out, new in zip(self.outputs, self.fn(self.floats)):
            out.copy_(new)


@pytest.fixture()
def stand_in_capture(monkeypatch):
    """Model._replay on the CPU: the warm-up stays a plain walk, the
    capture records the function (its launches go uncounted, as a real
    capture's do: they are restored)."""
    graphs = []

    def capture(fn, floats, stream, pool):
        outputs = fn(floats)
        graphs.append(_StandInGraph(fn, floats, outputs))
        return graphs[-1], outputs

    monkeypatch.setattr(TM, "_warm_up", lambda fn, floats, device:
                        fn(floats))
    monkeypatch.setattr(TM, "_capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    return graphs


def test_replay_bookkeeping(stand_in_capture):
    """One capture per signature; each call copies its inputs into the
    graph's buffers, counts one forward's launches and returns fresh
    tensors equal to the eager walk's; an input read in place is never
    copied, and another tensor there captures anew in the old graph's
    place."""
    jproto = testgen.gemm(3, 4, 2, random_seed=0)
    qmodel = _port(jproto).quantize(
        [RNG.normal(size=(3, 4)).astype(np.float32)], bit_width=8)
    xs = [torch.from_numpy(RNG.normal(size=(3, 4)).astype(np.float32))
          for _ in range(3)]
    outs = [qmodel._replay([x], ()) for x in xs]
    eager = [qmodel([x], as_numpy=False)[0] for x in xs]
    assert len(stand_in_capture) == 1 and len(qmodel._graphs) == 1
    assert stand_in_capture[0].replays == 3
    for got, want in zip(outs, eager):
        torch.testing.assert_close(got[0], want, rtol=0, atol=0)
    assert outs[0][0] is not outs[1][0]
    assert outs[0][0].data_ptr() != stand_in_capture[0].outputs[0].data_ptr()

    bound = xs[0].clone()
    qmodel._replay([bound], (0,))
    graph = stand_in_capture[-1]
    assert len(stand_in_capture) == 2 and graph.floats[0] is bound
    bound.copy_(xs[1])  # the caller writes its tensor in place
    got = qmodel._replay([bound], (0,))[0]
    torch.testing.assert_close(got, eager[1], rtol=0, atol=0)
    assert len(stand_in_capture) == 2 and len(qmodel._graphs) == 1
    other = xs[2].clone()
    torch.testing.assert_close(qmodel._replay([other], (0,))[0], eager[2],
                               rtol=0, atol=0)
    assert len(stand_in_capture) == 3 and len(qmodel._graphs) == 1


def test_replay_adds_the_captured_launches(stand_in_capture, monkeypatch):
    """A capture leaves the counters as they were; each replay adds what
    the capture recorded."""
    model = _port(testgen.gemm(3, 4, 2, random_seed=0))
    x = torch.from_numpy(RNG.normal(size=(3, 4)).astype(np.float32))
    real = TM._capture_graph

    def capture(fn, floats, stream, pool):
        TK.fused_attention.launches += 2  # the capture "records" two
        return real(fn, floats, stream, pool)

    monkeypatch.setattr(TM, "_capture_graph", capture)
    monkeypatch.setattr(TK.fused_attention, "launches", 5)
    model._replay([x], ())
    assert TK.fused_attention.launches == 5 + 2
    model._replay([x], ())
    assert TK.fused_attention.launches == 5 + 4


def test_a_failed_capture_names_the_node(stand_in_capture, monkeypatch):
    model = _port(testgen.gemm(3, 4, 2, random_seed=0))
    x = torch.from_numpy(RNG.normal(size=(3, 4)).astype(np.float32))

    def capture(fn, floats, stream, pool):
        model._failed = (model.nodes[0], RuntimeError("CUDA error 900"))
        raise RuntimeError("capture invalidated")

    monkeypatch.setattr(TM, "_capture_graph", capture)
    with pytest.raises(RuntimeError, match=r"node 'Gemm' \(Gemm\): CUDA "
                                           r"error 900"):
        model._replay([x], ())
    assert model._graphs == {}


# -- the capture-safety guard ------------------------------------------------

class _HostReads(TorchDispatchMode):
    """Records every op that reads a tensor's values back to the host
    (boolean-mask indexing among them)."""
    READS = ("_local_scalar_dense", "nonzero", "equal", "masked_select")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.READS or name in ("index", "index_put", "index_put_") \
                and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in args[1] if i is not None):
            # a boolean mask index counts its hits on the host
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


class _HostArrays(TorchFunctionMode):
    """Records host arrays made into tensors (torch.as_tensor/tensor of
    non-tensor data) and tensor values read out (numpy/tolist/item/cpu)."""

    def __init__(self):
        super().__init__()
        self.made, self.read = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.as_tensor, torch.tensor) \
                and not isinstance(args[0], torch.Tensor):
            self.made.append(func.__name__)
        if func in (torch.Tensor.numpy, torch.Tensor.tolist,
                    torch.Tensor.item, torch.Tensor.cpu):
            self.read.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _guarded(forward, monkeypatch):
    """Run ``forward`` once as a warm-up, then again under the guards:
    (host reads, host arrays made into tensors)."""
    forward()
    made = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy",
                        lambda a: made.append("from_numpy") or real(a))
    placed = intops.placements
    reads, arrays = _HostReads(), _HostArrays()
    with arrays, reads:
        forward()
    monkeypatch.undo()
    made += arrays.made + ["place"] * (intops.placements - placed)
    return reads.seen + arrays.read, made


def _vit_packed():
    _, qmodel, x = _vit_qmodel()
    qmodel.optimize()
    assert qmodel.pack_weights() > 0
    return qmodel, [torch.from_numpy(x)]


def _gpt_w4_step():
    weights = TG.random_gpt2_weights(GPT_CFG, seed=0)
    model = Model.from_onnx(TG.gpt_decode_step(weights, GPT_CFG,
                                               batch_size=B,
                                               max_len=MAX_LEN),
                            device="cpu")
    assert model.quantize_weights(bit_width=4, group_size=8) > 0
    nh, hd = GPT_CFG["n_head"], GPT_CFG["n_embd"] // GPT_CFG["n_head"]
    caches = [torch.from_numpy(RNG.normal(size=(B, nh, MAX_LEN, hd))
                               .astype(np.float32))
              for _ in range(2 * GPT_CFG["n_layer"])]
    x = torch.from_numpy(RNG.normal(size=(B, 1, GPT_CFG["n_embd"]))
                         .astype(np.float32))
    return model, [x, torch.from_numpy(TGEN._step_mask(5, MAX_LEN))] + caches


def _llama_int8_step():
    """The int8 fused decode step (DecodeAttention) fed int8 caches."""
    weights = TL.random_llama_weights(LLAMA_CFG, seed=0)
    proto = TL.llama_decode_step(weights, LLAMA_CFG, batch_size=B,
                                 max_len=MAX_LEN)
    model = Model.from_onnx(proto, device="cpu")
    prompt = RNG.integers(0, LLAMA_CFG["vocab_size"], size=(B, 4))
    batches = TGEN.decode_calibration(model, prompt, proto._wte, None,
                                      rope=proto._rope_tables)
    stats = merge_calibration_stats(*[model.calibration_stats(b)
                                      for b in batches])
    qmodel = model.quantize(stats=stats, bit_width=8)
    assert qmodel.optimize()["fuse_decode_attention"] == \
        LLAMA_CFG["num_hidden_layers"]
    inputs = list(batches[-1][:4])
    for v, cache in zip(qmodel.inputs[4:], batches[-1][4:]):
        qp = qmodel.quant_params[v.name]
        inputs.append(quantize(cache, 8, qp.scale, qp.zero_point,
                               container=torch.int8))
    return qmodel, inputs


def _t5_int8():
    weights = TT.random_t5_weights(T5_CFG, seed=0)
    model = Model.from_onnx(TT.t5_conditional_generation(
        weights, T5_CFG, batch_size=B, src_len=12, tgt_len=8), device="cpu")
    wte = weights["shared.weight"]
    x = [wte[RNG.integers(0, T5_CFG["vocab_size"], size=(B, n))]
         for n in (12, 8)]
    qmodel = model.quantize(x, bit_width=8)
    assert qmodel.optimize()["fuse_attention"] > 0
    return qmodel, [torch.from_numpy(a) for a in x]


@pytest.mark.parametrize("path,mode,dtype", [
    ("vit", "unpack", "f32"), ("vit", "kernel", "f32"),
    ("vit", "unpack", "bf16"), ("vit", "kernel", "bf16"),
    ("gpt_w4_step", "unpack", "f32"), ("gpt_w4_step", "kernel", "f32"),
    ("llama_int8_step", "unpack", "f32"), ("t5", "unpack", "f32")])
def test_capture_safety_guard(path, mode, dtype, monkeypatch):
    """After one warm-up walk, a forward reads no tensor value on the host
    and turns no host array into a tensor: what the capture needs (a read
    would sync the host; a fresh host copy would replay from a buffer that
    is gone)."""
    build = {"vit": _vit_packed, "gpt_w4_step": _gpt_w4_step,
             "llama_int8_step": _llama_int8_step, "t5": _t5_int8}[path]
    model, inputs = build()
    floats = TC.low_precision_floats() if dtype == "bf16" \
        else contextlib.nullcontext()
    with packed_execution(mode), floats:
        reads, made = _guarded(lambda: model(inputs, as_numpy=False),
                               monkeypatch)
    assert reads == [], reads
    assert made == [], made


# -- the tools against JAX's --------------------------------------------------

class _Calls:
    """The model with its calls going through ``spy``."""

    def __init__(self, model, spy):
        self.__dict__["_model"], self.__dict__["_spy"] = model, spy

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, inputs, **kw):
        return self._spy(inputs, **kw)


def test_generate_kv_caches_are_the_graph_buffers():
    """generate_kv passes its caches as the step graph's in-place inputs,
    the same tensors from one decode to the next, and its tokens equal
    JAX's both times."""
    import transformers
    from numpy_quant_tpu.models import gpt as JG

    weights = TG.random_gpt2_weights(GPT_CFG, seed=0)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        **GPT_CFG, activation_function="gelu",
        attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    prompt = RNG.integers(0, GPT_CFG["vocab_size"], size=(B, 4))
    jp = JG.gpt_decode_step(module=hf, batch_size=B, max_len=MAX_LEN)
    jgen = importlib.import_module("numpy_quant_tpu.utils.generate")
    want = np.asarray(jgen.generate_kv(nq.Model.from_onnx(jp), prompt,
                                       jp._wte, jp._wpe, 6))
    tp = TG.gpt_decode_step(weights, GPT_CFG, batch_size=B, max_len=MAX_LEN)
    model = Model.from_onnx(tp, device="cpu")
    seen = []

    def spy(inputs, **kw):
        seen.append((kw.get("inplace"), [id(t) for t in inputs[2:]]))
        return model(inputs, **kw)

    calls = _Calls(model, spy)
    got = [TGEN.generate_kv(calls, prompt, tp._wte, tp._wpe, 6)
           for _ in range(2)]
    for g in got:
        np.testing.assert_array_equal(g, want)
    caches = 2 * GPT_CFG["n_layer"]
    assert {s[0] for s in seen} == {tuple(range(2, 2 + caches))}
    assert len({tuple(s[1]) for s in seen}) == 1  # one set of caches


def test_profile_results_plot_matches_jax(capsys):
    prof = {"Gemm": 0.5, "Relu": 0.1, "Add": 0.02}
    qprof = {"Gemm": 0.2, "TinyqQuant": 0.05, "TinyqDequant": 0.01,
             "Relu": 0.0}
    for show in (2, 5):
        assert profiling.profile_results_plot(prof, qprof, show=show) \
            == JPROF.profile_results_plot(prof, qprof, show=show)


def test_summarize_matches_jax():
    jm = nq.Model.from_onnx(nq.onnx.load(MLP))
    tm = Model.from_onnx(T_ONNX.load(MLP), device="cpu")
    assert summary.summarize(tm) == JS.summarize(jm)
    x = RNG.normal(size=(16, 2)).astype(np.float32)
    assert summary.summarize(tm.quantize([x])) \
        == JS.summarize(jm.quantize([x]))


def _vit_pair():
    jproto = JV.vit(2, 32, 8, 64, 48, 4)
    x = RNG.normal(size=(2, 3, 32, 32)).astype(np.float32)
    return nq.Model.from_onnx(jproto), _port(jproto), x


def test_record_all_values_matches_jax():
    """The same value names as JAX's record; float values within 1e-4 of
    max|value| (and compare_all_values's mean-L1 rule at 4 decimals),
    int8 ones dequantized within 1e-2 of max|value|."""
    jm, tm, x = _vit_pair()
    want, got = JP.record_all_values(jm, [x]), parity.record_all_values(
        tm, [x])
    assert set(got) == set(want)
    parity.compare_all_values(got, want, decimal=4)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1.0),
                                   err_msg=name)
    stats = jm.calibration_stats([x])
    jq = jm.quantize(stats=stats, bit_width=8)
    tq = tm.quantize(stats=stats, bit_width=8)
    qwant, qgot = JP.record_all_values(jq, [x]), parity.record_all_values(
        tq, [x])
    assert set(qgot) == set(qwant)
    for name, w in qwant.items():
        np.testing.assert_allclose(qgot[name], w, rtol=0,
                                   atol=1e-2 * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)
    with pytest.raises(AssertionError, match="Mean elementwise"):
        name = next(n for n, w in want.items() if np.abs(w).max() > 0.1)
        parity.compare_all_values({name: got[name] + 1.0},
                                  {name: want[name]})


def test_quantization_report_matches_jax(capsys):
    """The same rows in the same order, SQNR within 1e-3 dB."""
    jm = nq.Model.from_onnx(nq.onnx.load(MLP))
    tm = Model.from_onnx(T_ONNX.load(MLP), device="cpu")
    x = RNG.normal(size=(64, 2)).astype(np.float32)
    jq, tq = jm.quantize([x], bit_width=4), tm.quantize([x], bit_width=4)
    want = JA.quantization_report(jm, jq, [x])
    got = analyzer.quantization_report(tm, tq, [x])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g[0], g[3]) == (w[0], w[3])
        assert abs(g[1] - w[1]) <= 1e-3
        np.testing.assert_allclose(g[2], w[2], rtol=1e-5)
    analyzer.print_quantization_report(tm, tq, [x], top=3)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["value", "SQNR", "dB", "mean|err|", "op"]
    assert len(lines) == 1 + min(3, len(got))


def test_summarize_device_trace_reads_a_torch_trace(tmp_path):
    """A torch.profiler trace written on the CPU holds no device work;
    the same trace with device events (kernels, a copy, a fill) added
    reads back by kernel, instances grouped, host events -- a graph
    replay's launch among them -- left out."""
    import json

    trace_dir = str(tmp_path)
    out = profiling.device_trace(lambda a: a @ a, torch.ones(8, 8),
                                 trace_dir=trace_dir)
    assert float(out[0, 0]) == 8.0
    assert profiling.summarize_device_trace(trace_dir) == []
    assert profiling.device_busy_seconds(trace_dir) == 0.0
    (path,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    with open(path) as fh:
        trace = json.load(fh)
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    trace["traceEvents"] += [
        {"ph": "X", "cat": "kernel", "name": "void nq_hs<64, true>(P)",
         "pid": 0, "tid": 7, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void nq_hs<16, false>(P)",
         "pid": 0, "tid": 7, "ts": 200, "dur": 300},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD",
         "pid": 0, "tid": 7, "ts": 600, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "pid": 1, "tid": 1, "ts": 0, "dur": 900},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
         "pid": 1, "tid": 1, "ts": 0, "dur": 777}]
    with open(path, "w") as fh:
        json.dump(trace, fh)
    rows = profiling.summarize_device_trace(trace_dir)
    assert rows == [("nq_hs", 400 / 1e6, 2), ("Memcpy DtoD", 20 / 1e6, 1)]
    assert len(profiling.summarize_device_trace(
        trace_dir, group_stems=False)) == 3
    assert profiling.device_busy_seconds(trace_dir) == pytest.approx(
        420 / 1e6)


# a captured graph's DOT print (cuGraphDebugDotPrint), cut to three kernel
# nodes of a T5-small forward and one memcpy node
DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_49" graph[style="dashed"];
"graph_49_node_0"[style="solid" shape="record" label="{KERNEL
| {ID | 0 (topoId: 937) | _ZN47_GLOBAL__N__3dc38c7a_14_elementwise_cu_ad16d44d10qdq_kernelILb1EfiEEvPKT0_PT1_PKfPKv8EWParams\<\<\<2048,256,0\>\>\>}
}"];
"graph_49_node_1"[style="solid" shape="record" label="{KERNEL
| {ID | 1 (topoId: 936) | _ZN47_GLOBAL__N__3dc38c7a_14_elementwise_cu_ad16d44d10qdq_kernelILb1EfiEEvPKT0_PT1_PKfPKv8EWParams\<\<\<512,256,0\>\>\>}
}"];
"graph_49_node_35"[style="solid" shape="record" label="{KERNEL
| {ID | 35 (topoId: 902) | _ZN55_GLOBAL__N__1567fa3a_22_attention_hs_blockq_cu_51bd45b013blockq_kernelILi64ELb1ELi0EEEvPKaS2_S2_PKfPv8HSParams\<\<\<\{8,8,8\},256,0\>\>\>}
}"];
"graph_49_node_36"[style="solid" shape="record" label="{MEMCPY
| {ID | 36 (topoId: 901) | DtoD | 1048576}
}"];
}
}
"""


def test_dot_kernels_counts_a_graphs_kernel_nodes():
    """graph_kernels' reader: kernel nodes by symbol in a graph's DOT
    print, other nodes left out."""
    got = profiling.dot_kernels(DOT)
    assert sum(got.values()) == 3 and len(got) == 2
    (qdq, n), = [(k, n) for k, n in got.items() if "qdq_kernel" in k]
    assert n == 2 and qdq.startswith("_ZN47_GLOBAL__N_")

