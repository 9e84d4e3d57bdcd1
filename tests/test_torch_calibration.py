"""The port's calibration surface held against the JAX package's, on the
small trained ViT fixture at B=4, in TPU-mode numerics (x64 off):

* ``percentile_range`` equals ``jnp.quantile`` (linear, float32 q) bit
  for bit on the same arrays, past 2^24 elements too, and the port's
  ``calibration_stats(percentile=)`` equals ``jnp.quantile`` of the port's
  own values bit for bit; against JAX's stats within 1e-5 relative, at
  least 283 (min/max) and 283 (percentile) of 285 bit-equal (the
  classifier's Gemm, a weight product, keeps torch's order);
* the "jit", "eager" and "auto" modes give equal stats;
* ``mse_clipped_stats`` and ``kl_calibrated_stats`` equal JAX's: at most
  1% of the ranges differ, each only to an adjacent grid point (the count
  is printed);
* ``quantize(percentile=)`` gives the QModel that JAX's ``quantize`` makes
  from the same stats: equal payloads and quantization parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import numpy_quant_tpu as nq
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.models import fixtures as JF
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu.utils import calibration as JCAL
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.graph import Constant
from numpy_quant_tpu_torch.models import fixtures as TF
from numpy_quant_tpu_torch.quantization import percentile_range
from numpy_quant_tpu_torch.tensor import QTensor
from numpy_quant_tpu_torch.utils import calibration as TCAL
from numpy_quant_tpu_torch.utils.parity import record_all_values
from .torch_parity import assert_mapped_xla_cpu_host

import torch

B = 4
PCT = 99.9


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def vit():
    calib, _ = TF.make_batch(np.random.default_rng(7), B)
    with jax.enable_x64(False):
        jm = nq.Model.from_onnx(JF.trained_vit_onnx(batch_size=B))
    return dict(calib=calib, jm=jm,
                tm=Model.from_onnx(TF.trained_vit_onnx(batch_size=B),
                                   device="cpu"))


def _jnp_range(a, pct):
    """jnp.quantile as the JAX package's eager calibration walk calls it."""
    flat = jnp.asarray(np.asarray(a, np.float32).reshape(-1))
    lo = jnp.quantile(flat, np.float32(1.0 - pct / 100.0))
    hi = jnp.quantile(flat, np.float32(pct / 100.0))
    return np.float32(lo), np.float32(hi)


@pytest.mark.parametrize("n,pct", [(1, 99.9), (2, 75.0), (1000, 99.99),
                                   (4097, 100.0), (98304, 99.9),
                                   (2 ** 24 + 3, 99.99)])
def test_percentile_range_equals_jnp_quantile(n, pct):
    rng = np.random.default_rng(n)
    a = (rng.standard_t(3, size=n) * 0.7).astype(np.float32)
    got = percentile_range(torch.from_numpy(a), pct).numpy()
    want = _jnp_range(a, pct)
    assert got[0] == want[0] and got[1] == want[1], (got, want)


def test_percentile_stats_equal_jnp_quantile_of_port_values(vit):
    tm, calib = vit["tm"], vit["calib"]
    stats = tm.calibration_stats([calib], percentile=PCT)
    values = record_all_values(tm, [calib])
    consts = {v.name for v in tm.values if isinstance(v, Constant)}
    checked = 0
    for name, arr in values.items():
        if arr.dtype != np.float32:
            continue
        want = (np.float32(arr.min()), np.float32(arr.max())) \
            if name in consts else _jnp_range(arr, PCT)
        assert stats[name] == want, (name, stats[name], want)
        checked += 1
    print(f"percentile stats equal to jnp.quantile: {checked}")
    assert checked > 200


def test_minmax_stats_against_jax(vit):
    """Min/max stats: 283 of 285 bit-equal to JAX's since the port's CPU
    float math replays XLA's orders: the row sums and the IEEE square root
    (177 from 172), then the batched attention dots, the softmax's exp and
    row sums and the exact erf's exp (283); the classifier's Gemm, a weight
    product, still parts (ROADMAP queue 3 item 3); all within 1e-5
    relative."""
    assert_mapped_xla_cpu_host()
    js = vit["jm"].calibration_stats([vit["calib"]])
    ts = vit["tm"].calibration_stats([vit["calib"]])
    assert set(js) == set(ts)
    same = sum(js[k] == ts[k] for k in js)
    print(f"min/max stats bit-equal to JAX's: {same} of {len(js)}")
    assert same >= 283
    for k in js:
        np.testing.assert_allclose(np.float32(ts[k]), np.float32(js[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_percentile_stats_against_jax(vit):
    assert_mapped_xla_cpu_host()
    js = vit["jm"].calibration_stats([vit["calib"]], percentile=PCT)
    ts = vit["tm"].calibration_stats([vit["calib"]], percentile=PCT)
    assert set(js) == set(ts)
    same = sum(js[k][0] == ts[k][0] and js[k][1] == ts[k][1] for k in js)
    print(f"percentile stats bit-equal to JAX's: {same} of {len(js)}")
    assert same >= 283      # 155, then 167 (row sums, sqrt), then 283
    for k in js:
        np.testing.assert_allclose(np.float32(ts[k]), np.float32(js[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the graph input and the patch embedding precede every matmul
    for k in ("inputs", "embeddings/Conv_out"):
        assert js[k] == ts[k], k


@pytest.mark.parametrize("percentile", [None, PCT])
def test_stat_modes_agree(vit, percentile):
    tm, calib = vit["tm"], vit["calib"]
    runs = [tm.calibration_stats([calib], mode=m, percentile=percentile)
            for m in ("jit", "eager", "auto")]
    for other in runs[1:]:
        assert other == runs[0]


def _grid_step_apart(a, b, step):
    """Whether positive a and b lie at most one geometric step apart."""
    return abs(np.log(a / b)) <= np.log(step) * 1.01


def test_mse_stats_match_jax(vit):
    js = JCAL.mse_clipped_stats(vit["jm"], [vit["calib"]])
    ts = TCAL.mse_clipped_stats(vit["tm"], [vit["calib"]])
    raw = vit["tm"].calibration_stats([vit["calib"]])
    assert set(js) == set(ts)
    step = (1.0 / 0.02) ** (1.0 / 23)
    differ = 0
    for k in js:
        if np.allclose(np.float32(ts[k]), np.float32(js[k]), rtol=1e-5,
                       atol=1e-7):
            continue
        differ += 1
        for side in (0, 1):
            if js[k][side] != 0 and raw[k][side] != 0:
                assert _grid_step_apart(ts[k][side] / raw[k][side],
                                        js[k][side] / raw[k][side], step), k
    print(f"MSE ranges differing from JAX's: {differ} of {len(js)}")
    assert differ <= 0.01 * len(js)


def test_kl_stats_match_jax(vit):
    js = JCAL.kl_calibrated_stats(vit["jm"], [vit["calib"]])
    ts = TCAL.kl_calibrated_stats(vit["tm"], [vit["calib"]])
    assert set(js) == set(ts)
    differ = 0
    for k in js:
        if np.allclose(np.float32(ts[k]), np.float32(js[k]), rtol=1e-5,
                       atol=1e-7):
            continue
        differ += 1
        # one histogram bin: at most max|x| / n_bins
        bin_width = max(abs(js[k][0]), abs(js[k][1])) / 512
        np.testing.assert_allclose(np.float32(ts[k]), np.float32(js[k]),
                                   rtol=0, atol=1.01 * bin_width, err_msg=k)
    print(f"KL ranges differing from JAX's: {differ} of {len(js)}")
    assert differ <= 0.01 * len(js)


def test_quantize_percentile_gives_jax_qmodel(vit):
    tm, calib = vit["tm"], vit["calib"]
    kw = dict(bit_width=8, weight_bit_width=4, per_channel_weights=True)
    tq = tm.quantize([calib], percentile=PCT, **kw)
    stats = tm.calibration_stats([calib], percentile=PCT)
    jq = vit["jm"].quantize(stats=stats, **kw)
    consts = {v.name: v.data for v in jq.values
              if isinstance(v, JConstant) and isinstance(v.data, JQTensor)}
    n = 0
    for v in tq.values:
        if isinstance(v, Constant) and isinstance(v.data, QTensor):
            want = consts[v.name]
            np.testing.assert_array_equal(v.data.data.numpy(),
                                          np.asarray(want.data), v.name)
            np.testing.assert_array_equal(np.asarray(v.data.scale),
                                          np.asarray(want.scale), v.name)
            n += 1
    assert n == len(consts)
    assert set(tq.quant_params) == set(jq.quant_params)
    for name, qp in jq.quant_params.items():
        mine = tq.quant_params[name]
        np.testing.assert_array_equal(np.asarray(mine.scale, np.float32),
                                      np.asarray(qp.scale, np.float32), name)
        assert (mine.zero_point is None) == (qp.zero_point is None), name
        if qp.zero_point is not None:
            assert int(mine.zero_point) == int(qp.zero_point), name
    # and the clipped ranges really differ from min/max on the activations
    plain = tm.quantize([calib], **kw)
    assert any(float(plain.quant_params[k].scale) != float(qp.scale)
               for k, qp in tq.quant_params.items()
               if np.asarray(qp.scale).ndim == 0)
