"""The port's pipeline parallelism (numpy_quant_tpu_torch/parallel/
pipeline.py) on the CPU: four gloo ranks spawned once for the file.
Counterparts of the JAX package's two pipeline tests (GPipe over 4 and 2
stages, float, weight-only, int8 and int8 after optimize(); PP x TP over
a (pipe, model) = (2, 2) mesh), each held against the port's
single-process result (integer paths equal, float within JAX's rtol 1e-4
/ atol 1e-5 and argmax equal); split_stages' cut points held against
JAX's node for node; and the int8 GPipe held end to end against JAX's
pipelined program on 2 virtual devices."""
import jax
import numpy as np
import pytest

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import text_fixture as JT
from numpy_quant_tpu.parallel.pipeline import split_stages as j_split
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.models import text_fixture as TT
from numpy_quant_tpu_torch.parallel.mesh import Ranks
from numpy_quant_tpu_torch.parallel.pipeline import split_stages as t_split

from . import torch_parallel_cases as C


@pytest.fixture(scope="module")
def jax_gpt():
    """JAX's trained GPT at B=8 on the copy batch: (its model, the input,
    its calibration stats), built once for the file."""
    b = 8
    ids = TT.make_copy_batch(np.random.default_rng(4), b)
    with jax.enable_x64(False):
        jproto = JT.trained_gpt_onnx(batch_size=b)
        x = np.take(jproto._wte, ids, axis=0).astype(np.float32)
        jm = nq.Model.from_onnx(jproto)
        stats = jm.calibration_stats([x])
    return jm, x, stats


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4, backend="gloo", device="cpu", timeout_s=240,
               threads=1) as r:
        yield r


def test_pipeline_parallel_gpipe_matches_single_device(ranks):
    out = ranks.run(C.gpipe)
    for o in out[1:]:
        np.testing.assert_array_equal(o["q"], out[0]["q"])
    np.testing.assert_array_equal(out[1]["q2"], out[0]["q2"])


def test_pipeline_tp_composition_matches_single_device(ranks):
    assert all(ranks.run(C.pp_tp))


def test_int8_gpipe_matches_jax_pipeline(ranks, jax_gpt):
    """The int8 GPipe against JAX's, end to end: both packages quantize the
    trained GPT on JAX's stats, split it in 2 stages at the same value and
    pipeline 4 microbatches (JAX: one shard_map program over 2 virtual
    devices; the port: 2 gloo ranks); logits within the cross-package
    contract (1e-2 of max|logit|), labels equal under the margin rule."""
    from numpy_quant_tpu import parallel as jpar
    from numpy_quant_tpu.parallel.pipeline import pipeline_forward as j_pipe
    jm, x, stats = jax_gpt
    with jax.enable_x64(False):
        jq = jm.quantize(stats=stats, bit_width=8)
        whole = np.asarray(jq([x])[0])
        jstages = j_split(jq, 2)
        want = j_pipe(jstages, jpar.make_mesh(2, axes=("pipe",), shape=(2,)),
                      x, (whole.shape, whole.dtype), n_microbatches=4)
    stats = {k: (np.float32(v[0]), np.float32(v[1]))
             for k, v in stats.items()}
    cuts, got = ranks.run(C.gpipe_on_stats, stats)[0]
    assert cuts == [sm.inputs[0].name for sm in jstages]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * float(np.abs(want).max()))
    # labels equal wherever JAX's top-2 margin clears the logits' distance
    # (the port's CPU float ops round apart from XLA's: ROADMAP queue 3)
    gap = np.abs(got - want).max(-1)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * gap
    print(f"positions whose margin clears the gap: {clear.sum()} of "
          f"{clear.size}")
    assert clear.mean() > 0.9, clear.mean()
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def _cuts(stages):
    return [(sm.inputs[0].name, [n.name for n in sm.nodes])
            for sm in stages]


@pytest.mark.parametrize("n_stages", [2, 4])
def test_split_stages_cut_points_match_jax(n_stages, jax_gpt):
    """The same stage boundaries and node lists as JAX's split_stages,
    on the float graph and on the int8 graph after optimize() (QModel
    cuts skip accumulators and planned int8 values)."""
    jm, x, stats = jax_gpt
    with jax.enable_x64(False):
        jq = jm.quantize(stats=stats, bit_width=8)
        jq.optimize()
        want = _cuts(j_split(jm, n_stages))
        want_q = _cuts(j_split(jq, n_stages))
    tm = Model.from_onnx(TT.trained_gpt_onnx(batch_size=8), device="cpu")
    tq = tm.quantize(stats=stats, bit_width=8)
    tq.optimize()
    assert _cuts(t_split(tm, n_stages)) == want
    assert _cuts(t_split(tq, n_stages)) == want_q
