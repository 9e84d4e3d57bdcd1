"""The port's ``serve_ring`` held to the JAX package's contract
(``tests/test_inference.py::test_serve_ring_matches_per_call``) on the
reference's ``mlp.onnx``, float and int8, on the CPU (the eager walk in the
ring's loop):

* per-batch outputs equal ``__call__``'s bit for bit, and JAX's
  ``serve_ring`` outputs within 1e-6 with equal labels (float, and int8
  from JAX's stats: the float softmax after the last dequantize rounds an
  ulp apart);
* one pull per step, inside the session, batch k+1 pulled after forward k
  and before a further forward;
* ``[]`` for an empty feed, a second session reusing the first's capture
  key, an error naming "signature" on a mid-session change (raised after
  the outputs before it were made), ``RuntimeError`` for a second session
  of the same signature while one runs, ``ValueError`` on a sharded model
  and on int64 inputs;
* the gate: ``NQ_TPU_RING=0`` raises naming map_batches, ``probe=False``
  bypasses it, and the unforced probe runs the ring's shape in a
  subprocess (cached; a watchdog timeout is False).
"""
import os

import jax
import numpy as np
import pytest

import numpy_quant_tpu as nq
from numpy_quant_tpu_torch import Model, onnx as T_ONNX
from numpy_quant_tpu_torch import serving as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP = os.path.join(ROOT, "numpy_quant_tpu_torch", "models", "mlp.onnx")
XS = np.random.default_rng(0).normal(size=(6, 16, 2)).astype(np.float32)


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def models():
    tm = Model.from_onnx(T_ONNX.load(MLP), device="cpu")
    jm = nq.Model.from_onnx(nq.onnx.load(
        os.path.join(ROOT, "numpy_quant_tpu", "models", "mlp.onnx")))
    stats = jm.calibration_stats([XS.reshape(-1, 2)])
    return dict(t=tm, j=jm, tq=tm.quantize(stats=stats, bit_width=8),
                jq=jm.quantize(stats=stats, bit_width=8))


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv("NQ_TPU_RING", "1")


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_outputs_equal_calls_and_jax(models, forced, kind, monkeypatch):
    tm, jm = (models["t"], models["j"]) if kind == "float" \
        else (models["tq"], models["jq"])
    seq = [tm([x])[0] for x in XS]
    pulled, launched = [], []
    call = Model.__call__

    def counting(self, *a, **kw):
        launched.append(len(pulled))
        return call(self, *a, **kw)

    def live():
        for i, x in enumerate(XS):
            # forward i-1 is made before batch i is pulled, and no later one
            assert len(launched) == i
            pulled.append(i)
            yield [x]

    monkeypatch.setattr(Model, "__call__", counting)
    got = tm.serve_ring(live())
    monkeypatch.setattr(Model, "__call__", call)
    assert pulled == list(range(len(XS))) and len(got) == len(XS)
    assert launched == list(range(1, len(XS) + 1))
    for g, s in zip(got, seq):
        np.testing.assert_array_equal(g[0], s)
    want = jm.serve_ring([x] for x in XS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(g[0].argmax(-1),
                                      np.asarray(w[0]).argmax(-1))


def test_session_edge_cases(models, forced):
    tm = models["t"]
    seq = [tm([x])[0] for x in XS]
    assert tm.serve_ring(iter([])) == []
    again = tm.serve_ring([x] for x in XS[:2])
    assert len(again) == 2
    np.testing.assert_array_equal(again[1][0], seq[1])
    pulled = []

    def bad():
        pulled.append(0)
        yield [XS[0]]
        pulled.append(1)
        yield [XS[1][:4]]
        pulled.append(2)
        yield [XS[2]]

    with pytest.raises(ValueError, match="signature"):
        tm.serve_ring(bad())
    assert pulled == [0, 1]          # the session ended at the bad batch
    assert tm._ring_state == {}


def test_second_session_of_a_signature_refused(models, forced):
    tm = models["t"]
    seen = []

    def feed():
        yield [XS[0]]
        with pytest.raises(RuntimeError, match="already running"):
            tm.serve_ring([[XS[1]]])
        seen.append("refused")
        # another signature may run meanwhile
        seen.append(len(tm.serve_ring([[XS[1][:4]]])))
        yield [XS[2]]

    assert len(tm.serve_ring(feed())) == 2
    assert seen == ["refused", 1]


@pytest.mark.parametrize("case", ["sharded", "int64"])
def test_refusals(models, forced, case):
    tm = models["t"]
    if case == "sharded":
        tm.mesh = object()
        try:
            with pytest.raises(ValueError, match="one device"):
                tm.serve_ring([[XS[0]]])
        finally:
            tm.mesh = None
    else:
        with pytest.raises(ValueError, match="float inputs only"):
            tm.serve_ring([[np.zeros((16, 2), np.int64)]])


def test_gate(models, monkeypatch):
    tm = models["t"]
    monkeypatch.setenv("NQ_TPU_RING", "0")
    with pytest.raises(RuntimeError, match="map_batches"):
        tm.serve_ring([x] for x in XS)
    assert len(tm.serve_ring(([x] for x in XS[:1]), probe=False)) == 1
    monkeypatch.delenv("NQ_TPU_RING")
    monkeypatch.setattr(TS, "_RING_PROBE_CACHE", {})
    assert TS.ring_supported(timeout=0.01) is False     # the watchdog
    monkeypatch.setattr(TS, "_RING_PROBE_CACHE", {})
    assert TS.ring_supported() is True                  # the CPU ring runs
    assert TS._RING_PROBE_CACHE == {"ok": True}
    assert len(tm.serve_ring([x] for x in XS[:2])) == 2
