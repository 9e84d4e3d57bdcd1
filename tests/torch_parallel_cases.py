"""Rank-side cases of tests/test_torch_parallel.py and
tests/test_torch_pipeline.py: each runs on every rank of a live gloo group
on the CPU (parallel.mesh.Ranks), builds its small model from a seed,
holds the port's sharded result against the port's single-process result
on the same rank, and raises on a mismatch (the launcher re-raises the
rank's traceback). Imports no JAX: the ranks run the port alone.

Each case mirrors one test of the JAX package's tests/test_parallel.py at
the same model and mesh shape, its 8 virtual devices mapped onto 4 ranks:
DP 8 -> DP 4, DP x TP (8, tp=2) -> 2 x 2, (8, tp=4) -> 1 x 4."""
from __future__ import annotations

import os

import numpy as np
import torch

from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch import parallel as par
from numpy_quant_tpu_torch.models import vit as TV
from numpy_quant_tpu_torch.tensor import PackedQTensor

DEV = "cpu"
VIT_SMALL = dict(hidden_size=8, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=22, image_size=16, patch_size=4,
                 num_labels=10)
VIT_TP = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=24, image_size=16, patch_size=4,
              num_labels=10)
GPT_CFG = dict(vocab_size=96, n_positions=12, n_embd=32, n_layer=2,
               n_head=4)
LLAMA_CFG = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=64,
                 rms_norm_eps=1e-5, rope_theta=10000.0,
                 initializer_range=0.02, tie_word_embeddings=False)
BERT_CFG = dict(vocab_size=96, hidden_size=16, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=24,
                max_position_embeddings=16, num_labels=3)


def _rng(seed):
    return np.random.default_rng(seed)


def _vit(cfg, batch, seed=0):
    return TV.vit_image_classifier(TV.random_vit_weights(cfg, seed=seed,
                                                         std=0.2),
                                   cfg, batch_size=batch)


def _images(seed, batch):
    return _rng(seed).normal(size=(batch, 3, 16, 16)).astype(np.float32)


def _mesh(kind):
    if kind == "dp":
        return par.make_mesh(4, axes=("data",), device=DEV)
    if kind == "dptp":
        return par.make_dp_tp_mesh(4, tp=2, device=DEV)
    return par.make_dp_tp_mesh(4, tp=4, device=DEV)


def _equal(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _close(a, b, atol, what="", rtol=1e-7):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=what)


def _local(model, name):
    """(spec, this rank's piece) of a constant of a sharded model."""
    return model._local_specs().get(name), model._local_params().get(name)


def _heads_seen(model, x):
    """num_heads of each FusedAttentionHS launch of one forward."""
    from numpy_quant_tpu_torch.ops import registry as R
    seen = []
    orig = R.attention_call

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[3]["num_heads"])
        return out

    R.attention_call = spy
    try:
        out = model([x])[0]
    finally:
        R.attention_call = orig
    return seen, out


# ----------------------------------------------------------------------
# DP and TP on the ViT
# ----------------------------------------------------------------------


def dp_inference():
    proto = _vit(VIT_SMALL, 8)
    x = _images(1, 8)
    want = Model.from_onnx(proto, device=DEV)([x])[0]
    m = Model.from_onnx(proto, device=DEV)
    par.shard_model(m, _mesh("dp"))
    got = m([x])[0]
    _close(got, want, 1e-6)
    return got.shape


def dp_calibration():
    proto = _vit(VIT_SMALL, 8)
    x = _images(2, 8)
    stats = Model.from_onnx(proto, device=DEV).calibration_stats([x])
    m = Model.from_onnx(proto, device=DEV)
    par.shard_model(m, _mesh("dp"))
    got = m.calibration_stats([x])
    assert set(got) == set(stats)
    for name in stats:
        _close(got[name][0], stats[name][0], 1e-6, name)
        _close(got[name][1], stats[name][1], 1e-6, name)
    return len(stats)


def tp_inference():
    proto = _vit(VIT_TP, 4)
    x = _images(3, 4)
    want = Model.from_onnx(proto, device=DEV)([x])[0]
    m = Model.from_onnx(proto, device=DEV)
    par.shard_model(m, _mesh("tp"), rules=par.vit_tp_rules)
    got = m([x])[0]
    _close(got, want, 1e-5)
    name = "encoder.layer.0.attention.query.weight_t"
    spec, local = _local(m, name)
    assert spec == (None, "model"), spec
    assert tuple(local.data.shape) == (16, 4), local.data.shape
    return spec


def dp_tp_quantized():
    proto = _vit(VIT_TP, 8)
    x = _images(4, 8)
    q = Model.from_onnx(proto, device=DEV).quantize([x], bit_width=8)
    want = q([x])[0]
    par.shard_model(q, _mesh("dptp"), rules=par.vit_tp_rules)
    _equal(q([x])[0], want)
    return True


def mlp_dp_quantized():
    from numpy_quant_tpu_torch import onnx as T_ONNX
    from numpy_quant_tpu_torch.models import mlp as TM
    proto = T_ONNX.load(TM.MLP_ONNX) if hasattr(TM, "MLP_ONNX") else \
        T_ONNX.load(os.path.join(os.path.dirname(TM.__file__), "mlp.onnx"))
    X = _rng(5).normal(size=(800, 2)).astype(np.float32)
    q = Model.from_onnx(proto, device=DEV).quantize([X], bit_width=8)
    want = q([X])[0]
    par.shard_model(q, _mesh("dp"))
    _equal(q([X])[0], want)
    return True


def dp_tp_optimized_trained_vit():
    from numpy_quant_tpu_torch.models import fixtures as F
    proto = F.trained_vit_onnx(batch_size=8)
    x, _ = F.make_batch(_rng(5), 8)
    calib, _ = F.make_batch(_rng(6), 4)
    q = Model.from_onnx(proto, device=DEV).quantize([calib], bit_width=8)
    rep = q.optimize()
    assert rep["fuse_attention"] == 4, rep
    want = q([x])[0]
    q2 = Model.from_onnx(proto, device=DEV).quantize([calib], bit_width=8)
    q2.optimize()
    par.shard_model(q2, _mesh("dptp"), rules=par.vit_tp_rules)
    heads, got = _heads_seen(q2, x)
    _equal(got, want)
    assert heads == [2] * 4, heads  # 4 heads over tp = 2
    return heads


def dp_fused_attention():
    from numpy_quant_tpu_torch.models import fixtures as F
    proto = F.trained_vit_onnx(batch_size=8)
    x, _ = F.make_batch(_rng(15), 8)
    calib, _ = F.make_batch(_rng(16), 4)
    q = Model.from_onnx(proto, device=DEV).quantize([calib], bit_width=8)
    q.fuse_attention()
    want = q([x])[0]
    par.shard_model(q, _mesh("dp"))
    _equal(q([x])[0], want)
    return True


def tp_packed_column():
    proto = _vit(VIT_TP, 8)
    x = _images(6, 8)
    q = Model.from_onnx(proto, device=DEV).quantize([x], bit_width=8)
    par.shard_model(q, _mesh("dptp"), rules=par.vit_tp_rules)
    want = q([x])[0]
    assert q.pack_weights() >= 3
    packed = [v for v in q.values
              if isinstance(getattr(v, "data", None), PackedQTensor)]
    col = [v for v in packed if par.vit_tp_rules(v.name, 2) == (None, "model")]
    assert col
    for v in col:
        spec, local = _local(q, v.name)
        assert spec == ("column", "model"), (v.name, spec)
        assert local.planes.shape[-1] * 2 == v.data.planes.shape[-1]
        assert local.colsum.shape[-1] * 2 == v.data.colsum.shape[-1]
    _equal(q([x])[0], want)
    with TC_kernel():
        _equal(q([x])[0], want)
    return len(col)


class TC_kernel:
    """packed_execution = "kernel" (the plain versions on the CPU)."""

    def __enter__(self):
        self.prev = TC.packed_execution
        TC.packed_execution = "kernel"

    def __exit__(self, *exc):
        TC.packed_execution = self.prev
        return False


def w4a8_full_stack():
    proto = _vit(VIT_TP, 8)
    x = _images(7, 8)
    model = Model.from_onnx(proto, device=DEV)

    def build():
        q = model.quantize([x], bit_width=8, weight_bit_width=4,
                           per_channel_weights=True)
        q.optimize()
        assert q.pack_weights() > 0
        return q

    want = build()([x])[0]
    q2 = build()
    par.shard_model(q2, _mesh("dptp"), rules=par.vit_tp_rules)
    _equal(q2([x])[0], want)
    with TC_kernel():
        _equal(q2([x])[0], want)
    return True


def w3a8_dp_tp():
    """W3 bit-plane payloads (no stacked layout at 3 bits): column shards
    run packed at N/tp, row shards stay whole."""
    proto = _vit(VIT_TP, 8)
    x = _images(18, 8)
    model = Model.from_onnx(proto, device=DEV)

    def build():
        q = model.quantize([x], bit_width=8, weight_bit_width=3)
        q.optimize()
        assert q.pack_weights() > 0
        return q

    want = build()([x])[0]
    q = model.quantize([x], bit_width=8, weight_bit_width=3)
    par.shard_model(q, _mesh("dptp"), rules=par.vit_tp_rules)
    q.optimize()
    assert q.pack_weights() > 0
    assert not any(getattr(v.data, "layout", None) == "splitk_stacked"
                   for v in q.values)
    _equal(q([x])[0], want)
    with TC_kernel():
        _equal(q([x])[0], want)
    return True


def merge_under_mesh():
    proto = _vit(VIT_TP, 8)
    x = _images(8, 8)
    q = Model.from_onnx(proto, device=DEV).quantize([x], bit_width=8)
    want = q([x])[0]
    par.shard_model(q, _mesh("dptp"), rules=par.vit_tp_rules)
    assert q.merge_parallel_matmuls() > 0
    merged = [n for n in q.nodes if n.op == "MatMulSplit"]
    spec, local = _local(q, merged[0].inputs[1].name)
    assert spec == (None, "model"), spec
    assert local.data.shape[1] * 2 == merged[0].inputs[1].data.data.shape[1]
    _equal(q([x])[0], want)
    q.pack_weights()
    _equal(q([x])[0], want)
    with TC_kernel():
        _equal(q([x])[0], want)
    return len(merged)


def tp_row_stacked():
    proto = _vit(VIT_TP, 8)
    x = _images(9, 8)
    model = Model.from_onnx(proto, device=DEV)
    kw = dict(bit_width=8, weight_bit_width=4, per_channel_weights=True)
    base = model.quantize([x], **kw)
    assert base.pack_weights() > 0
    want = base([x])[0]
    q = model.quantize([x], **kw)
    par.shard_model(q, _mesh("dptp"), rules=par.vit_tp_rules)
    assert q.pack_weights() > 0
    rows = [v for v in q.values
            if isinstance(getattr(v, "data", None), PackedQTensor)
            and par.vit_tp_rules(v.name, 2) == ("model", None)]
    assert rows
    for v in rows:
        assert v.data.layout == "splitk_stacked", (v.name, v.data.layout)
        assert v.data.planes.shape[0] == 2
        spec, local = _local(q, v.name)
        assert spec == ("stacked", "model"), spec
        assert local.k * 2 == v.data.k  # this rank's K/2 rows
        assert local.planes.numel() * 2 == v.data.planes.numel()
        _equal(local.colsum, v.data.colsum)  # the global colsum
    _equal(q([x])[0], want)
    return len(rows)


def stacked_roundtrip(path):
    from numpy_quant_tpu_torch.utils.serialization import (load_qmodel,
                                                           save_qmodel)
    proto = _vit(VIT_TP, 8)
    x = _images(10, 8)
    q = Model.from_onnx(proto, device=DEV).quantize(
        [x], bit_width=8, weight_bit_width=4, per_channel_weights=True)
    par.shard_model(q, _mesh("dptp"), rules=par.vit_tp_rules)
    assert q.pack_weights() > 0
    want = q([x])[0]
    import torch.distributed as dist
    if dist.get_rank() == 0:
        save_qmodel(q, path, proto)
    dist.barrier()
    loaded = load_qmodel(path, device=DEV)
    assert any(getattr(v.data, "layout", None) == "splitk_stacked"
               for v in loaded.values)
    _equal(loaded([x])[0], want)
    par.shard_model(loaded, _mesh("dptp"), rules=par.vit_tp_rules)
    _equal(loaded([x])[0], want)
    return True


def tp_bert():
    from numpy_quant_tpu_torch.models import text as TT
    proto = TT.bert_text_classifier(TT.random_bert_weights(BERT_CFG, seed=5),
                                    BERT_CFG, batch_size=8, seq_len=12)
    ids = _rng(11).integers(0, 96, size=(8, 12)).astype(np.int64)
    q = Model.from_onnx(proto, device=DEV).quantize([ids], bit_width=8)
    want = q([ids])[0]
    par.shard_model(q, _mesh("dptp"), rules=par.vit_tp_rules)
    _close(q([ids])[0], want, 1e-5)
    name = next(v.name for v in q.values if v.name.endswith(".query.weight_t"))
    assert _local(q, name)[0] == (None, "model")
    return True


# ----------------------------------------------------------------------
# generation and serving
# ----------------------------------------------------------------------


def _gen():
    import importlib
    return importlib.import_module("numpy_quant_tpu_torch.utils.generate")


def _lm(arch, batch, seq=12):
    from numpy_quant_tpu_torch.models import gpt as TG, llama as TL
    if arch == "gpt":
        w = TG.random_gpt2_weights(GPT_CFG, seed=2, std=0.1)
        return TG.gpt_causal_lm(w, GPT_CFG, batch_size=batch, seq_len=seq)
    w = TL.random_llama_weights(LLAMA_CFG, seed=2)
    return TL.llama_causal_lm(w, LLAMA_CFG, batch_size=batch, seq_len=seq)


def tp_generation(arch):
    rules = par.gpt_tp_rules if arch == "gpt" else par.llama_tp_rules
    proto = _lm(arch, 4)
    embeds = _rng(12).normal(size=(4, 12, 32)).astype(np.float32)
    q = Model.from_onnx(proto, device=DEV).quantize([embeds], bit_width=8)
    want = q([embeds])[0]
    prompt = _rng(13).integers(0, 96, size=(4, 4)).astype(np.int32)
    seq = _gen().generate(q, prompt, proto._wte, max_new_tokens=6)
    par.shard_model(q, _mesh("dptp"), rules=rules)
    _close(q([embeds])[0], want, 1e-5)
    _equal(_gen().generate(q, prompt, proto._wte, max_new_tokens=6), seq)
    # sampling: every rank draws from the same gathered logits with the
    # same seeded generator, so the tokens agree without a broadcast
    drawn = _gen().generate(q, prompt, proto._wte, max_new_tokens=4,
                            temperature=1.0,
                            generator=torch.Generator().manual_seed(7))
    head = "lm_head.weight_t"
    assert _local(q, head)[0] == (None, "model")
    return drawn


def weight_only_dp_tp():
    proto = _lm("llama", 4)
    m = Model.from_onnx(proto, device=DEV)
    m.quantize_weights(bit_width=8)
    embeds = _rng(14).normal(size=(4, 12, 32)).astype(np.float32)
    want = m([embeds])[0]
    prompt = _rng(15).integers(0, 96, size=(4, 4)).astype(np.int32)
    seq = _gen().generate(m, prompt, proto._wte, max_new_tokens=5)
    par.shard_model(m, _mesh("dptp"), rules=par.llama_tp_rules)
    _close(m([embeds])[0], want, 1e-5)
    _equal(_gen().generate(m, prompt, proto._wte, max_new_tokens=5), seq)
    return True


def _decode_proto(batch=4, max_len=12):
    from numpy_quant_tpu_torch.models import gpt as TG
    w = TG.random_gpt2_weights(GPT_CFG, seed=2, std=0.1)
    return TG.gpt_decode_step(w, GPT_CFG, batch_size=batch, max_len=max_len)


def tp_kv_decode():
    from numpy_quant_tpu_torch.utils import (decode_calibration,
                                             merge_calibration_stats)
    G = _gen()
    proto = _decode_proto()
    prompt = _rng(16).integers(0, 96, size=(4, 4)).astype(np.int32)
    m = Model.from_onnx(proto, device=DEV)
    f_seq = G.generate_kv(m, prompt, proto._wte, proto._wpe,
                          max_new_tokens=6)
    par.shard_model(m, _mesh("dptp"), rules=par.gpt_tp_rules)
    _equal(G.generate_kv(m, prompt, proto._wte, proto._wpe,
                         max_new_tokens=6), f_seq)
    # the caches stay per rank: batch 4 / dp 2, heads 4 / tp 2
    shapes = {tuple(b[0].shape) for b in m._kv_buffers.values()}
    assert (2, 2, 12, 8) in shapes, shapes
    qm0 = Model.from_onnx(proto, device=DEV)
    batches = decode_calibration(qm0, prompt, proto._wte, proto._wpe)
    stats = merge_calibration_stats(
        *[qm0.calibration_stats(b) for b in batches])
    qm = qm0.quantize(stats=stats, bit_width=8)
    q_seq = G.generate_kv(qm, prompt, proto._wte, proto._wpe,
                          max_new_tokens=6)
    c_seq = G.generate_kv(qm, prompt, proto._wte, proto._wpe,
                          max_new_tokens=6, kv_cache_dtype="int8")
    par.shard_model(qm, _mesh("dptp"), rules=par.gpt_tp_rules)
    _equal(G.generate_kv(qm, prompt, proto._wte, proto._wpe,
                         max_new_tokens=6), q_seq)
    _equal(G.generate_kv(qm, prompt, proto._wte, proto._wpe,
                         max_new_tokens=6, kv_cache_dtype="int8"), c_seq)
    return True


def tp_llama_decode():
    """The int8 LLaMA step (grouped-query attention, fused
    DecodeAttention, Q/K/V merged) under DP x TP: tokens and every step's
    logits equal the single process's, float and int8 caches."""
    from numpy_quant_tpu_torch.models import llama as TL
    from numpy_quant_tpu_torch.utils import (decode_calibration,
                                             merge_calibration_stats)
    G = _gen()
    cfg = dict(LLAMA_CFG, hidden_size=64, num_attention_heads=8,
               num_key_value_heads=4)
    proto = TL.llama_decode_step(TL.random_llama_weights(cfg, seed=3), cfg,
                                 batch_size=4, max_len=20)
    rope = proto._rope_tables
    prompt = _rng(19).integers(0, 96, size=(4, 5)).astype(np.int32)
    m = Model.from_onnx(proto, device=DEV)
    stats = merge_calibration_stats(*[m.calibration_stats(b) for b in
                                      decode_calibration(m, prompt,
                                                         proto._wte, None,
                                                         rope=rope)])
    out = {}
    for cache in (None, "int8"):
        q = m.quantize(bit_width=8, stats=stats)
        q.optimize()
        want_rows = []
        want = G.generate_kv(q, prompt, proto._wte, None, 12, rope=rope,
                             kv_cache_dtype=cache, step_logits=want_rows)
        t = m.quantize(bit_width=8, stats=stats)
        par.shard_model(t, _mesh("dptp"), rules=par.llama_tp_rules)
        # per layer: q/k/v and the SwiGLU gate/up
        assert t.optimize()["merge_parallel_matmuls"] == 4
        rows = []
        got = G.generate_kv(t, prompt, proto._wte, None, 12, rope=rope,
                            kv_cache_dtype=cache, step_logits=rows)
        _equal(got, want, str(cache))
        _equal(torch.stack(rows), torch.stack(want_rows), str(cache))
        out[cache] = got
    return out


def tp_continuous_batcher():
    from numpy_quant_tpu_torch.utils.serving import ContinuousBatcher
    proto = _decode_proto()
    rng = _rng(17)
    workload = [(rng.integers(0, 96, size=(1 + i % 4,)).astype(np.int32), 5)
                for i in range(8)]
    m = Model.from_onnx(proto, device=DEV)
    want = ContinuousBatcher(m, proto._wte, proto._wpe).run(workload)
    s = Model.from_onnx(proto, device=DEV)
    par.shard_model(s, _mesh("dptp"), rules=par.gpt_tp_rules)
    got = ContinuousBatcher(s, proto._wte, proto._wpe).run(workload)
    assert sorted(got) == sorted(want)
    for k in want:
        _equal(got[k], want[k], str(k))
    return len(got)


# ----------------------------------------------------------------------
# launcher checks
# ----------------------------------------------------------------------


def raise_on_rank(bad: int):
    import torch.distributed as dist
    if dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    # the others block in a collective their peer never joins
    dist.all_reduce(torch.ones(1))
    return dist.get_rank()


def collectives():
    """all_reduce / all_gather / broadcast / send-recv over mesh axes."""
    import torch.distributed as dist
    mesh = _mesh("dptp")
    r = dist.get_rank()
    t = torch.tensor([float(r)])
    out = {
        "sum_model": float(par.all_reduce(t, mesh, "model")[0]),
        "sum_all": float(par.all_reduce(t, mesh, None)[0]),
        "gather_data": par.all_gather(t, mesh, "data").tolist(),
        "bcast": float(par.broadcast(t, mesh, "model", 1)[0]),
    }
    if r == 0:
        par.send(torch.arange(3, dtype=torch.int32), 3)
    if r == 3:
        out["recv"] = par.recv((3,), torch.int32, 0, "cpu").tolist()
    return out


# ----------------------------------------------------------------------
# pipelines
# ----------------------------------------------------------------------


def _trained_gpt(b):
    from numpy_quant_tpu_torch.models import text_fixture as TF
    proto = TF.trained_gpt_onnx(batch_size=b)
    ids = TF.make_copy_batch(_rng(4), b)
    x = np.take(proto._wte, ids, axis=0).astype(np.float32)
    return proto, x


def gpipe():
    from numpy_quant_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                         split_stages)
    B, Mb, S = 8, 4, 4
    proto, x = _trained_gpt(B)
    model = Model.from_onnx(proto, device=DEV)
    want = model([x])[0]
    mesh = par.make_mesh(S, axes=("pipe",), shape=(S,), device=DEV)
    got = pipeline_forward(split_stages(model, S), mesh, x,
                           (want.shape, want.dtype), n_microbatches=Mb)
    _close(got, want, 1e-5, rtol=1e-4)
    _equal(got.argmax(-1), want.argmax(-1))
    w = Model.from_onnx(proto, device=DEV)
    w.quantize_weights(bit_width=8)
    w_want = w([x])[0]
    w_got = pipeline_forward(split_stages(w, S), mesh, x,
                             (w_want.shape, w_want.dtype), n_microbatches=Mb)
    _close(w_got, w_want, 1e-5, rtol=1e-4)
    _equal(w_got.argmax(-1), w_want.argmax(-1))
    import torch.distributed as dist
    mesh2 = par.make_mesh(2, axes=("pipe",), shape=(2,), device=DEV)
    out = {}
    if dist.get_rank() < 2:
        got2 = pipeline_forward(split_stages(model, 2), mesh2, x,
                                (want.shape, want.dtype), n_microbatches=4)
        _close(got2, want, 1e-5, rtol=1e-4)
    q = model.quantize([x], bit_width=8)
    q_want = q([x])[0]
    q_stages = split_stages(q, S)
    assert all(getattr(sm, "quant_params", None) is not None
               for sm in q_stages)
    q_got = pipeline_forward(q_stages, mesh, x, (q_want.shape, q_want.dtype),
                             n_microbatches=Mb)
    _equal(q_got, q_want)  # integer products, the same float op sequence
    q2 = model.quantize([x], bit_width=8)
    q2.optimize()
    q2_want = q2([x])[0]
    if dist.get_rank() < 2:
        q2_got = pipeline_forward(split_stages(q2, 2), mesh2, x,
                                  (q2_want.shape, q2_want.dtype),
                                  n_microbatches=Mb)
        _equal(q2_got, q2_want)
        out["q2"] = q2_got
    out["q"] = q_got
    return out


def gpipe_on_stats(stats):
    """The int8 trained GPT quantized on the given stats, split in 2
    stages and pipelined over ranks 0 and 1 (4 microbatches): (stage
    input names, output) on rank 0."""
    from numpy_quant_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                         split_stages)
    proto, x = _trained_gpt(8)
    q = Model.from_onnx(proto, device=DEV).quantize(stats=stats, bit_width=8)
    want = q([x])[0]
    mesh = par.make_mesh(2, axes=("pipe",), shape=(2,), device=DEV)
    if not mesh.member:
        return None
    stages = split_stages(q, 2)
    got = pipeline_forward(stages, mesh, x, (want.shape, want.dtype),
                           n_microbatches=4)
    _equal(got, want)
    return [sm.inputs[0].name for sm in stages], got


def pp_tp():
    from numpy_quant_tpu_torch.parallel.pipeline import (
        pipeline_forward_stagewise, split_stages)
    B, Mb, S, TP = 8, 4, 2, 2
    proto, x = _trained_gpt(B)
    model = Model.from_onnx(proto, device=DEV)
    want = model([x])[0]
    stages = split_stages(model, S)
    mesh = par.make_mesh(S * TP, axes=("pipe", "model"), shape=(S, TP),
                         device=DEV)
    got = pipeline_forward_stagewise(stages, mesh, x, n_microbatches=Mb,
                                     rules=par.gpt_tp_rules)
    _close(got, want, 1e-5, rtol=1e-4)
    _equal(got.argmax(-1), want.argmax(-1))
    s = mesh.index("pipe")
    sm = stages[s]
    assert sm.mesh.axis_names == ("model",)
    assert any(spec == (None, "model")
               for spec in sm._local_specs().values()), "no TP shards"
    q = model.quantize([x], bit_width=8)
    q_want = q([x])[0]
    q_got = pipeline_forward_stagewise(split_stages(q, S), mesh, x,
                                       n_microbatches=Mb,
                                       rules=par.gpt_tp_rules)
    _equal(q_got, q_want)
    return True


def stage_cuts(n_stages):
    """Cut points (stage input names) of the trained GPT, float and int8
    optimized, on one rank."""
    from numpy_quant_tpu_torch.parallel.pipeline import split_stages
    proto, x = _trained_gpt(8)
    model = Model.from_onnx(proto, device=DEV)
    out = {"float": [sm.inputs[0].name
                     for sm in split_stages(model, n_stages)]}
    q = model.quantize([x], bit_width=8)
    q.optimize()
    out["q_opt"] = [sm.inputs[0].name for sm in split_stages(q, n_stages)]
    return out
