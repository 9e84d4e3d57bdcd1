"""Property tests of the port's quantization math against the JAX
package's, bit for bit (the counterpart of
``tests/test_quant_properties.py``, whose reference-oracle tests skip
where the reference is not mounted; these run everywhere): random ranges,
arrays and bit widths through ``quant_parameters``, ``quantize``,
``dequantize``, ``q_matmul`` and ``requantize``, and
``tensor_min_max``/``quantize_tensor_min_max``. Up to 8 bits the JAX side
runs in TPU mode (x64 off: int32 containers), above 8 in x64 mode (the
port's int64 containers). Hypothesis runs derandomized with a bounded
example count, so every run checks the same examples."""
import jax
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

import numpy_quant_tpu.quantization as JQ
import numpy_quant_tpu.tensor as JT
import numpy_quant_tpu_torch as pt
import numpy_quant_tpu_torch.quantization as Q

finite_f32 = st.floats(min_value=-1e4, max_value=1e4, width=32,
                       allow_nan=False, allow_infinity=False) \
    .map(lambda v: 0.0 if abs(v) < 1e-6 else v)


def _x64(bits):
    return jax.enable_x64(bits > 8)


def _minmax(lo, hi):
    mn, mx = np.float32(min(lo, hi)), np.float32(max(lo, hi))
    return min(mn, np.float32(0)), max(mx, np.float32(0))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(lo=finite_f32, hi=finite_f32, bits=st.integers(1, 16),
       asym=st.booleans())
def test_quant_parameters(lo, hi, bits, asym):
    mn, mx = _minmax(lo, hi)
    if asym and mx == mn:
        return
    s, zp = Q.quant_parameters(mn, mx, bits, asym)
    with _x64(bits):
        js, jzp = JQ.quant_parameters(mn, mx, bits, asym)
    assert np.float32(s) == np.float32(js)
    assert (zp is None) == (jzp is None)
    if zp is not None:
        assert np.int64(zp) == np.int64(jzp)


@settings(max_examples=20, deadline=None, derandomize=True)
@given(data=st.data(), bits=st.integers(2, 16), asym=st.booleans())
def test_quantize_dequantize(data, bits, asym):
    shape = data.draw(st.tuples(st.integers(1, 5), st.integers(1, 7)))
    x = np.asarray(data.draw(st.lists(finite_f32, min_size=shape[0] * shape[1],
                                      max_size=shape[0] * shape[1])),
                   np.float32).reshape(shape)
    mn, mx = _minmax(x.min(), x.max())
    if asym and mx == mn:
        return
    s, zp = Q.quant_parameters(mn, mx, bits, asym)
    if np.float32(s) == 0:
        return
    q = Q.quantize(torch.tensor(x), bits, s, zp)
    d = Q.dequantize(q, s, zp)
    with _x64(bits):
        jq = JQ.quantize(x, bits, s, zp)
        jd = JQ.dequantize(jq, s, zp)
        jq, jd = np.asarray(jq), np.asarray(jd)
    np.testing.assert_array_equal(q.numpy().astype(np.int64),
                                  jq.astype(np.int64))
    np.testing.assert_array_equal(d.numpy(), jd.astype(np.float32))


@settings(max_examples=20, deadline=None, derandomize=True)
@given(data=st.data(), bits=st.integers(2, 12), asym_a=st.booleans(),
       asym_b=st.booleans())
def test_q_matmul_requantize(data, bits, asym_a, asym_b):
    m, k, n = (data.draw(st.integers(1, hi)) for hi in (4, 6, 4))
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    ints = st.integers(lo, hi)
    qa = np.asarray(data.draw(st.lists(ints, min_size=m * k,
                                       max_size=m * k))).reshape(m, k)
    qb = np.asarray(data.draw(st.lists(ints, min_size=k * n,
                                       max_size=k * n))).reshape(k, n)
    scales = st.floats(float(np.float32(0.001)), 10.0, width=32)
    sa, sb, rs = (np.float32(data.draw(scales)) for _ in range(3))
    za = np.int64(data.draw(ints)) if asym_a else None
    zb = np.int64(data.draw(ints)) if asym_b else None
    rz = np.int64(data.draw(ints))
    dt = torch.int64 if bits > 8 else torch.int32
    acc, s, zp = Q.q_matmul(torch.tensor(qa, dtype=dt), sa, za,
                            torch.tensor(qb, dtype=dt), sb, zb, bit_width=bits)
    r = Q.requantize(acc, s, zp, rs, rz, bits)
    jdt = np.int64 if bits > 8 else np.int32
    with _x64(bits):
        jacc, js, jzp = JQ.q_matmul(qa.astype(jdt), sa, za, qb.astype(jdt),
                                    sb, zb, bit_width=bits)
        jr = np.asarray(JQ.requantize(jacc, js, jzp, rs, rz, bits))
        jacc = np.asarray(jacc)
        jzp = None if jzp is None else np.asarray(jzp)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64),
                                  jacc.astype(np.int64))
    assert np.float32(s) == np.float32(js)
    assert (zp is None) == (jzp is None)
    if zp is not None:
        np.testing.assert_array_equal(
            np.broadcast_to(zp.numpy(), acc.shape).astype(np.int64),
            np.broadcast_to(jzp, acc.shape).astype(np.int64))
    np.testing.assert_array_equal(r.numpy().astype(np.int64),
                                  jr.astype(np.int64))


@settings(max_examples=15, deadline=None, derandomize=True)
@given(data=st.data(), bits=st.integers(2, 8), asym=st.booleans())
def test_tensor_min_max_and_quantize_tensor_min_max(data, bits, asym):
    n = data.draw(st.integers(1, 12))
    x = np.asarray(data.draw(st.lists(finite_f32, min_size=n, max_size=n)),
                   np.float32)
    got = pt.tensor_min_max(pt.FTensor(torch.tensor(x)))
    with jax.enable_x64(False):
        want = JT.tensor_min_max(JT.FTensor(x))
    assert got == want and all(v.dtype == np.float32 for v in got)
    assert pt.tensor_min_max(pt.ITensor(x.astype(np.int64))) == \
        JT.tensor_min_max(JT.ITensor(x.astype(np.int64)))
    if asym and got[0] == got[1]:
        return
    q = pt.quantize_tensor_min_max(pt.FTensor(torch.tensor(x)), bits, asym)
    with jax.enable_x64(False):
        jq = JT.quantize_tensor_min_max(JT.FTensor(x), bits, asym)
        jdata = np.asarray(jq.data)
    assert np.float32(q.scale) == np.float32(jq.scale)
    np.testing.assert_array_equal(q.data.numpy(), jdata)


def test_package_root_exports_like_jax():
    import numpy_quant_tpu as nq
    for name in ("tensor_min_max", "quantize_tensor_min_max", "concat",
                 "where", "fconv2d"):
        assert name in pt.__all__ and name in nq.__all__
        assert callable(getattr(pt, name))
