"""The port's quantization math (numpy_quant_tpu_torch.quantization) held
bit for bit against numpy_quant_tpu.quantization in TPU-mode numerics
(x64 off), plus the port's import hygiene and device rule."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from numpy_quant_tpu import quantization as JQ
from numpy_quant_tpu_torch import config as TC
from numpy_quant_tpu_torch import quantization as TQ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _minmax(x):
    return (np.minimum(x.min(), np.float32(0.0)),
            np.maximum(x.max(), np.float32(0.0)))


def _qparams(x, bits, asym):
    s, z = JQ.quant_parameters(*_minmax(x), bits, asym)
    ts, tz = TQ.quant_parameters(*_minmax(x), bits, asym)
    np.testing.assert_array_equal(s, ts)
    assert z == tz
    return s, z


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("bits", range(1, 9))
def test_quantize_dequantize_bit_equal(bits, asym):
    rng = np.random.default_rng(100 * bits + asym)
    x = (rng.normal(size=(37, 29)) * 3 + 0.5).astype(np.float32)
    s, z = _qparams(x, bits, asym)
    jq = np.asarray(JQ.quantize(x, bits, s, z))
    tq = TQ.quantize(_t(x), bits, s, z)
    assert tq.dtype == torch.int32 and jq.dtype == np.int32
    np.testing.assert_array_equal(tq.numpy(), jq)
    jd = np.asarray(JQ.dequantize(jq, s, z))
    td = TQ.dequantize(_t(jq), s, z).numpy()
    assert td.dtype == np.float32
    np.testing.assert_array_equal(td, jd)
    # int8 storage dequantizes to the same floats
    if bits <= 8:
        np.testing.assert_array_equal(
            TQ.dequantize(_t(jq.astype(np.int8)), s, z).numpy(), jd)


@pytest.mark.parametrize("zp_b", [False, True])
@pytest.mark.parametrize("zp_a", [False, True])
@pytest.mark.parametrize("bits", range(1, 9))
def test_q_matmul_bit_equal(bits, zp_a, zp_b):
    rng = np.random.default_rng(1000 + 10 * bits + 2 * zp_a + zp_b)
    a = (rng.normal(size=(2, 19, 24)) + 0.7).astype(np.float32)
    b = (rng.normal(size=(24, 13)) - 0.3).astype(np.float32)
    sa, za = _qparams(a, bits, zp_a)
    sb, zb = _qparams(b, bits, zp_b)
    qa = np.asarray(JQ.quantize(a, bits, sa, za))
    qb = np.asarray(JQ.quantize(b, bits, sb, zb))
    jacc, jscale, jzp = JQ.q_matmul(qa, sa, za, qb, sb, zb, bit_width=bits)
    tacc, tscale, tzp = TQ.q_matmul(_t(qa), sa, za, _t(qb), sb, zb,
                                    bit_width=bits)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(np.asarray(tscale), np.asarray(jscale))
    if jzp is None:
        assert tzp is None
    else:
        assert tzp.dtype == torch.int32
        np.testing.assert_array_equal(tzp.numpy(), np.asarray(jzp))


@pytest.mark.parametrize("asym_out", [False, True])
@pytest.mark.parametrize("bits", range(1, 9))
def test_requantize_bit_equal(bits, asym_out):
    rng = np.random.default_rng(2000 + 10 * bits + asym_out)
    a = (rng.normal(size=(11, 32)) + 0.2).astype(np.float32)
    b = rng.normal(size=(32, 16)).astype(np.float32)
    sa, za = _qparams(a, 8, True)
    sb, zb = _qparams(b, 8, False)
    qa = np.asarray(JQ.quantize(a, 8, sa, za))
    qb = np.asarray(JQ.quantize(b, 8, sb, zb))
    acc, scale, zp = JQ.q_matmul(qa, sa, za, qb, sb, zb, bit_width=8)
    y = np.asarray(JQ.dequantize(acc, scale, zp))
    rs, rz = _qparams(y, bits, asym_out)
    jr = np.asarray(JQ.requantize(acc, scale, zp, rs, rz, bits))
    tr = TQ.requantize(_t(np.asarray(acc)), scale, _t(np.asarray(zp)),
                       rs, rz, bits)
    assert tr.dtype == torch.int32
    np.testing.assert_array_equal(tr.numpy(), jr)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_per_channel_chain_bit_equal(bits, axis):
    """per_channel_scales, quantize, q_matmul, dequantize and requantize
    with a per-channel weight scale ([1, N] for a MatMul weight; [N, 1]
    for a transposed Gemm weight, which the product sees as [1, N])."""
    rng = np.random.default_rng(3000 + 10 * bits + axis)
    a = (rng.normal(size=(2, 9, 24)) + 0.4).astype(np.float32)
    w = rng.normal(size=(24, 13) if axis == 1 else (13, 24)).astype(np.float32)
    channel0 = (slice(None), 0) if axis == 1 else (0, slice(None))
    w[channel0] = -np.abs(w[channel0])  # an all-negative channel
    jsw = JQ.per_channel_scales(w, bits, axis)
    tsw = TQ.per_channel_scales(w, bits, axis)
    assert tsw.dtype == np.float32 and tsw.shape == jsw.shape
    np.testing.assert_array_equal(tsw, jsw)
    qw = np.asarray(JQ.quantize(w, bits, jsw, None))
    np.testing.assert_array_equal(TQ.quantize(_t(w), bits, tsw, None).numpy(),
                                  qw)
    if axis == 0:  # Gemm transB: the product takes the transposed weight
        qw, jsw = qw.T.copy(), jsw.T.copy()
    sa, za = _qparams(a, 8, True)
    qa = np.asarray(JQ.quantize(a, 8, sa, za))
    jacc, jscale, jzp = JQ.q_matmul(qa, sa, za, qw, jsw, None, bit_width=8)
    tacc, tscale, tzp = TQ.q_matmul(_t(qa), sa, za, _t(qw), jsw, None,
                                    bit_width=8)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert np.asarray(tscale).shape == (1, 13)
    np.testing.assert_array_equal(np.asarray(tscale), np.asarray(jscale))
    np.testing.assert_array_equal(tzp.numpy(), np.asarray(jzp))
    jd = np.asarray(JQ.dequantize(jacc, jscale, jzp))
    np.testing.assert_array_equal(TQ.dequantize(tacc, tscale, tzp).numpy(), jd)
    rs, rz = _qparams(jd, 8, True)
    np.testing.assert_array_equal(
        TQ.requantize(tacc, tscale, tzp, rs, rz, 8).numpy(),
        np.asarray(JQ.requantize(jacc, jscale, jzp, rs, rz, 8)))


@pytest.mark.parametrize("shape", [(1, 8, 8), (5, 3, 7), (16, 9, 13),
                                   (17, 24, 16), (40, 64, 48),
                                   (197, 768, 10)])
def test_int_matmul_exact(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * k * n)
    a = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    y = TQ.int_matmul(_t(a), _t(b))
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(
        y.numpy(), a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("batched_rhs", [False, True])
def test_int_matmul_batched_exact(batched_rhs):
    rng = np.random.default_rng(7 + batched_rhs)
    a = rng.integers(-128, 128, size=(2, 3, 5, 12)).astype(np.int8)
    b = rng.integers(-128, 128, size=(2, 3, 12, 9) if batched_rhs
                     else (12, 9)).astype(np.int8)
    y = TQ.int_matmul(_t(a), _t(b))
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(
        y.numpy(), np.matmul(a.astype(np.int64), b.astype(np.int64)))


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import numpy_quant_tpu_torch\n"
            "import numpy_quant_tpu_torch.convert\n"
            "import numpy_quant_tpu_torch.kernels\n"
            "import numpy_quant_tpu_torch.models.vit\n"
            "import numpy_quant_tpu_torch.models.gpt\n"
            "import numpy_quant_tpu_torch.passes\n"
            "import numpy_quant_tpu_torch.utils.generate\n"
            "import numpy_quant_tpu_torch.profile_vit\n"
            "import numpy_quant_tpu_torch.profile_gpt\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'numpy_quant_tpu' or "
            "m.startswith('numpy_quant_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.vit import (random_vit_weights,
                                                  vit_image_classifier)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
               intermediate_size=32, image_size=16, patch_size=8,
               num_labels=3)
    proto = vit_image_classifier(random_vit_weights(cfg, seed=0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model.from_onnx(proto)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.resolve_device()
    assert Model.from_onnx(proto, device="cpu").device.type == "cpu"
