"""The port's data and tensor parallelism (numpy_quant_tpu_torch/parallel)
on the CPU: four ranks over gloo, spawned once for the file, each case of
tests/torch_parallel_cases.py fed to the live ranks. One port counterpart
per test of the JAX package's tests/test_parallel.py (same small models,
its 8 virtual devices mapped onto 4 ranks), each holding the port's
sharded result against the port's single-process result: integer paths
and generated tokens equal, float outputs within JAX's own atol. Then
holds against JAX directly, graph-only: the stacked packed payloads
byte for byte, and the merged graph and optimize() report under tp = 2
after JAX's shard_model; and one MatMulSplit forward against JAX's op.

Hang safety: every group has a deadline, a rank that raises makes the
launcher raise its traceback within 60 s (tested), and the rank side
imports no JAX."""
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu import parallel as jpar
from numpy_quant_tpu.models import fixtures as JF
from numpy_quant_tpu.ops.registry import onnx_operator_implementation as jop
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu.tensor import pack_qtensor as j_pack_qtensor
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import parallel as par
from numpy_quant_tpu_torch.models import fixtures as TF
from numpy_quant_tpu_torch.ops.registry import \
    onnx_operator_implementation as top
from numpy_quant_tpu_torch.parallel.mesh import Mesh, RankError, Ranks
from numpy_quant_tpu_torch.tensor import QTensor, pack_qtensor

from . import torch_parallel_cases as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4, backend="gloo", device="cpu", timeout_s=240,
               threads=1) as r:
        yield r


def _same_on_every_rank(results):
    for r in results[1:]:
        np.testing.assert_equal(r, results[0])
    return results[0]


# ----------------------------------------------------------------------
# counterparts of tests/test_parallel.py
# ----------------------------------------------------------------------


def test_dp_inference_matches_single_device(ranks):
    assert ranks.run(C.dp_inference)[0] == (8, 10)


def test_dp_calibration_matches_single_device(ranks):
    assert _same_on_every_rank(ranks.run(C.dp_calibration)) > 0


def test_tp_inference_matches_single_device(ranks):
    assert ranks.run(C.tp_inference)[0] == (None, "model")


def test_dp_tp_quantized_inference(ranks):
    assert all(ranks.run(C.dp_tp_quantized))


def test_mlp_dp_quantized(ranks):
    assert all(ranks.run(C.mlp_dp_quantized))


def test_dp_tp_optimized_bit_exact_trained_vit(ranks):
    # each rank's FusedAttentionHS launches ran on 4 / tp = 2 heads
    assert ranks.run(C.dp_tp_optimized_trained_vit) == [[2] * 4] * 4


def test_dp_fused_attention_bit_exact(ranks):
    assert all(ranks.run(C.dp_fused_attention))


def test_tp_packed_weights_shard_over_model_axis(ranks):
    assert _same_on_every_rank(ranks.run(C.tp_packed_column)) >= 4


def test_w4a8_full_stack_dp_tp(ranks):
    assert all(ranks.run(C.w4a8_full_stack))


def test_w3a8_bitplanes_dp_tp(ranks):
    assert all(ranks.run(C.w3a8_dp_tp))


def test_merge_parallel_matmuls_under_mesh(ranks):
    assert ranks.run(C.merge_under_mesh) == [2] * 4


def test_tp_row_sharded_packed_payloads(ranks):
    assert _same_on_every_rank(ranks.run(C.tp_row_stacked)) == 4


def test_stacked_packed_serialization_roundtrip(ranks, tmp_path):
    assert all(ranks.run(C.stacked_roundtrip, str(tmp_path / "q.onnx")))


def test_tp_bert_text_quantized(ranks):
    assert all(ranks.run(C.tp_bert))


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_tp_quantized_generation(ranks, arch):
    """test_tp_gpt_quantized_generation and
    test_tp_llama_quantized_generation; the seeded sampled tokens agree
    on every rank."""
    drawn = ranks.run(C.tp_generation, arch)
    _same_on_every_rank(drawn)
    assert drawn[0].shape == (4, 8)


def test_weight_only_dp_tp(ranks):
    assert all(ranks.run(C.weight_only_dp_tp))


def test_tp_kv_decode_matches_single_device(ranks):
    assert all(ranks.run(C.tp_kv_decode))


def test_tp_llama_decode_matches_single_device(ranks):
    out = ranks.run(C.tp_llama_decode)
    _same_on_every_rank(out)


def test_tp_continuous_batcher_matches_single_device(ranks):
    assert ranks.run(C.tp_continuous_batcher) == [8] * 4


# ----------------------------------------------------------------------
# the launcher and the collectives
# ----------------------------------------------------------------------


def test_collectives_over_mesh_axes(ranks):
    out = ranks.run(C.collectives)
    # 2 x 2 mesh, rank = 2 * data + model
    assert [o["sum_model"] for o in out] == [1.0, 1.0, 5.0, 5.0]
    assert all(o["sum_all"] == 6.0 for o in out)
    assert [o["gather_data"] for o in out] == [[0.0, 2.0], [1.0, 3.0],
                                               [0.0, 2.0], [1.0, 3.0]]
    assert [o["bcast"] for o in out] == [1.0, 1.0, 3.0, 3.0]
    assert out[3]["recv"] == [0, 1, 2]


def test_rank_failure_raises_within_60_s():
    start = time.monotonic()
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        par.spawn(C.raise_on_rank, 2, 1, device="cpu", timeout_s=60,
                  threads=1)
    assert time.monotonic() - start < 60


def test_nccl_refuses_two_ranks_on_one_device():
    with pytest.raises(ValueError, match="gloo"):
        Ranks(2, backend="nccl", device="cuda")


def test_rank_side_imports_no_jax():
    code = ("import sys\n"
            "import tests.torch_parallel_cases\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'numpy_quant_tpu' or "
            "m.startswith('numpy_quant_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ----------------------------------------------------------------------
# against JAX directly
# ----------------------------------------------------------------------


@pytest.mark.parametrize("bits,k,shards", [(8, 48, 2), (4, 48, 2),
                                           (4, 40, 4), (2, 64, 4),
                                           (1, 96, 2)])
def test_stacked_payload_equals_jax(bits, k, shards):
    """pack_qtensor(shards=) gives JAX's splitk_stacked payload and global
    colsum byte for byte (pad rows where K does not divide), and unpacks
    to the weight."""
    rng = np.random.default_rng(bits * 100 + k)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(lo, hi + 1, size=(k, 24)).astype(np.int32)
    jp = j_pack_qtensor(JQTensor(w, bits, np.float32(0.5), None),
                        shards=shards)
    tp = pack_qtensor(QTensor(torch.from_numpy(w), bits, np.float32(0.5),
                              None), shards=shards)
    assert jp.layout == tp.layout == "splitk_stacked"
    assert tp.planes.numpy().tobytes() == np.asarray(jp.planes).tobytes()
    np.testing.assert_array_equal(tp.colsum.numpy(), np.asarray(jp.colsum))
    np.testing.assert_array_equal(tp.unpack().data.numpy(), w)


@pytest.fixture(scope="module")
def merged_pair():
    """(JAX QModel, port QModel) of the trained ViT fixture on JAX's
    stats, each sharded tp = 2 and optimized (graph only on the port
    side: its mesh is a layout without a process group)."""
    with jax.enable_x64(False):
        calib, _ = JF.make_batch(np.random.default_rng(6), 4)
        jm = nq.Model.from_onnx(JF.trained_vit_onnx(batch_size=8))
        stats = jm.calibration_stats([calib])
        jq = jm.quantize(stats=stats, bit_width=8)
        jpar.shard_model(jq, jpar.make_dp_tp_mesh(8, tp=2), data_axis="data",
                         rules=jpar.vit_tp_rules)
        jrep = jq.optimize()
    tq = Model.from_onnx(TF.trained_vit_onnx(batch_size=8),
                         device="cpu").quantize(stats=stats, bit_width=8)
    layout = Mesh(np.arange(8).reshape(4, 2), ("data", "model"), "cpu")
    par.shard_model(tq, layout, rules=par.vit_tp_rules)
    trep = tq.optimize()
    return jq, jrep, tq, trep


def test_optimize_report_and_merged_graph_match_jax(merged_pair):
    jq, jrep, tq, trep = merged_pair
    assert trep == {k: jrep[k] for k in trep}
    assert trep["merge_parallel_matmuls"] == 4  # Q/K/V of each layer
    assert [n.op for n in tq.nodes] == [n.op for n in jq.nodes]
    for jn, tn in zip(jq.nodes, tq.nodes):
        if tn.op == "MatMulSplit":
            for key in ("segments", "segment_scales", "source_weights"):
                assert list(tn.attrs[key]) == list(jn.attrs[key]), key
            assert tn.inputs[1].name == jn.inputs[1].name
    assert "MatMulSplit" in tq.quantized_ops
    # merged weights take their source weights' rule
    name = next(n.inputs[1].name for n in tq.nodes if n.op == "MatMulSplit")
    assert tq._shard_rules(name, 2) == (None, "model")


def test_matmul_split_op_equals_jax():
    """The MatMulSplit op on the same integers: JAX's segments (data,
    scale, zero-point correction) equal the port's exactly."""
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, size=(2, 5, 16)).astype(np.int32)
    w = rng.integers(-127, 128, size=(16, 24)).astype(np.int32)
    segs, scales = [8, 8, 8], [0.01, 0.02, 0.03]
    sv = np.concatenate([np.full((1, 8), np.float32(s)) for s in scales], 1)
    attrs = {"segments": segs, "segment_scales": scales}
    with jax.enable_x64(False):
        jo = jop("MatMulSplit",
                 [JQTensor(x, 8, np.float32(0.1), np.int64(3)),
                  JQTensor(w, 8, sv, None)], attrs)
    to = top("MatMulSplit",
             [QTensor(torch.from_numpy(x), 8, np.float32(0.1), np.int64(3)),
              QTensor(torch.from_numpy(w), 8, sv, None)], attrs)
    assert len(jo) == len(to) == 3
    for j, t in zip(jo, to):
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        assert np.float32(t.scale) == np.float32(j.scale)
        np.testing.assert_array_equal(t.zero_point.numpy(),
                                      np.asarray(j.zero_point))


def test_merged_forward_equals_unmerged():
    """The merged port model equals its unmerged self bit for bit (f32),
    under both packed executions."""
    from numpy_quant_tpu_torch import config as TC
    calib, _ = TF.make_batch(np.random.default_rng(6), 4)
    x, _ = TF.make_batch(np.random.default_rng(7), 8)
    proto = TF.trained_vit_onnx(batch_size=8)
    model = Model.from_onnx(proto, device="cpu")
    unmerged = model.quantize([calib], bit_width=8)
    assert unmerged.optimize()["merge_parallel_matmuls"] == 0
    want = unmerged([x])[0]
    q = model.quantize([calib], bit_width=8)
    q._opt_merge_matmuls = True
    assert q.optimize()["merge_parallel_matmuls"] == 4
    np.testing.assert_array_equal(q([x])[0], want)
    q.pack_weights()
    for mode in ("unpack", "kernel"):
        prev, TC.packed_execution = TC.packed_execution, mode
        try:
            np.testing.assert_array_equal(q([x])[0], want)
        finally:
            TC.packed_execution = prev


@pytest.mark.parametrize("n", [17, 20])
def test_rank_heads_sum_where_they_lie(n):
    """A tensor-parallel rank's heads (head_base / head_total) give the
    whole model's values for those heads: the exact softmax rows are
    summed where they lie among all the heads."""
    from numpy_quant_tpu_torch.kernels.attention import (
        fused_attention_hs_reference as ref)
    rng = np.random.default_rng(n)
    q, k, v = (torch.from_numpy(rng.integers(-128, 128, size=(2, n, 4 * 8))
                                .astype(np.int8)) for _ in range(3))
    kw = dict(scaling=0.35, sq=0.05, zq=3, sk=0.04, zk=-5, sv=0.03, zv=2,
              sp=1 / 255, zp_p=-128)
    whole = ref(q, k, v, num_heads=4, **kw)
    for r in range(2):
        cols = slice(16 * r, 16 * (r + 1))
        got = ref(q[..., cols].contiguous(), k[..., cols].contiguous(),
                  v[..., cols].contiguous(), num_heads=2, head_base=2 * r,
                  head_total=4, **kw)
        np.testing.assert_array_equal(got.numpy(), whole[..., cols].numpy())
