"""The port's serving shapes (``serving.py::map_batches``, ``serve_stream``,
``serve_ring``; ``Model.map_batches``/``serve_stream``/``serve_ring``) on a
small ViT
(2 layers, hidden 64, 4 heads, intermediate 128, 32x32 images, 8x8 patches,
10 labels), float and int8 (quantized with JAX's stats; the int8 model also
``optimize()``d and ``pack_weights()``ed under both packed executions), in
TPU-mode numerics (x64 off).

Tolerances: the port's ``map_batches``, ``serve_stream`` and ``serve_ring``
outputs equal its own per-batch ``__call__`` bit for bit. Against JAX's
``map_batches`` and ``serve_ring``:
float logits within 1e-5 * max|logit|; int8 labels equal and logits within
1e-2 * max|logit| (``tests/test_torch_vit.py``'s bound: an intermediate may
round 1 LSB apart).
"""
import jax
import numpy as np
import pytest
import torch
from transformers import ViTConfig
from transformers.models.vit.modeling_vit import ViTForImageClassification

import numpy_quant_tpu as nq
from numpy_quant_tpu import config as JC
from numpy_quant_tpu.models import vit as JV
from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch.models import vit as TV
from numpy_quant_tpu_torch.serving import map_batches, serve_stream

CFG = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, image_size=32, patch_size=8,
           num_labels=10)
STEPS, BATCH = 3, 4


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def vit():
    weights = TV.random_vit_weights(CFG, seed=0)
    hf = ViTForImageClassification(
        ViTConfig(**CFG, attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    rng = np.random.default_rng(0)
    calib = rng.normal(size=(4, 3, 32, 32)).astype(np.float32)
    xs = rng.normal(size=(STEPS, BATCH, 3, 32, 32)).astype(np.float32)
    with jax.enable_x64(False):
        jm = nq.Model.from_onnx(JV.vit_image_classifier(module=hf))
        stats = jm.calibration_stats([calib])
        jq = jm.quantize(stats=stats, quantize_conv=True)
        jqp = jm.quantize(stats=stats, quantize_conv=True)
        jqp.optimize()
        jqp.pack_weights()
    tm = Model.from_onnx(TV.vit_image_classifier(weights, CFG), device="cpu")
    tq = tm.quantize(stats=stats, quantize_conv=True)
    tqp = tm.quantize(stats=stats, quantize_conv=True)
    tqp.optimize()
    tqp.pack_weights()
    return dict(xs=xs, j={"float": jm, "int8": jq, "int8_packed": jqp},
                t={"float": tm, "int8": tq, "int8_packed": tqp})


@pytest.fixture(params=["unpack", "kernel"])
def execution(request):
    prev = JC.packed_execution, TC.packed_execution
    JC.packed_execution = TC.packed_execution = request.param
    yield request.param
    JC.packed_execution, TC.packed_execution = prev


def _per_call(model, xs):
    return np.stack([model([x])[0] for x in xs])


def _close_to_jax(got, want, kind):
    scale = float(np.abs(want).max())
    if kind == "float":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale)


@pytest.mark.parametrize("kind", ["float", "int8", "int8_packed"])
def test_map_batches_equals_calls_and_jax(vit, execution, kind):
    tm = vit["t"][kind]
    xs = vit["xs"]
    got = tm.map_batches([xs])
    assert len(got) == 1 and got[0].shape == (STEPS, BATCH, 10)
    np.testing.assert_array_equal(got[0], _per_call(tm, xs))
    dev = map_batches(tm, [torch.from_numpy(xs)], as_numpy=False)[0]
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), got[0])
    with jax.enable_x64(False):
        want = vit["j"][kind].map_batches([xs])[0]
    _close_to_jax(got[0], np.asarray(want), kind)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_serve_stream_equals_calls_in_order(vit, depth):
    tm = vit["t"]["int8_packed"]
    xs = vit["xs"]
    outs = list(tm.serve_stream(([x] for x in xs), depth=depth))
    assert len(outs) == STEPS
    np.testing.assert_array_equal(np.stack([o[0] for o in outs]),
                                  _per_call(tm, xs))
    dev = list(serve_stream(tm, ([x] for x in xs), depth=depth,
                            as_numpy=False))
    assert all(isinstance(o[0], torch.Tensor) for o in dev)


def test_serve_stream_keeps_depth_in_flight(vit):
    """At most ``depth`` forwards are issued ahead of the result read."""
    tm = vit["t"]["float"]
    issued = []

    def batches():
        for i, x in enumerate(vit["xs"]):
            issued.append(i)
            yield [x]

    stream = serve_stream(tm, batches(), depth=2)
    next(stream)
    assert issued == [0, 1]
    next(stream)
    assert issued == [0, 1, 2]


@pytest.mark.parametrize("case", ["int64_input", "depth_0"])
def test_refusals(vit, case):
    tm = vit["t"]["float"]
    if case == "int64_input":
        with pytest.raises(ValueError, match="float inputs only"):
            tm.map_batches([np.zeros((2, 4), np.int64)])
    else:
        with pytest.raises(ValueError, match="depth"):
            list(tm.serve_stream([[vit["xs"][0]]], depth=0))


@pytest.mark.parametrize("kind", ["float", "int8", "int8_packed"])
def test_serve_ring_equals_calls_and_jax(vit, execution, kind, monkeypatch):
    """``serve_ring`` over a live generator: one pull per step, every
    output equal to ``__call__``'s; against JAX's ``serve_ring`` under
    "unpack"."""
    monkeypatch.setenv("NQ_TPU_RING", "1")
    tm, xs = vit["t"][kind], vit["xs"]
    pulled = []

    def live():
        for i, x in enumerate(xs):
            pulled.append(i)
            yield [x]

    got = tm.serve_ring(live())
    assert pulled == list(range(STEPS)) and len(got) == STEPS
    np.testing.assert_array_equal(np.stack([g[0] for g in got]),
                                  _per_call(tm, xs))
    if execution == "kernel":
        return  # JAX's ring is held once per model, under "unpack"
    with jax.enable_x64(False):
        want = vit["j"][kind].serve_ring([x] for x in xs)
    _close_to_jax(np.stack([g[0] for g in got]),
                  np.stack([np.asarray(w[0]) for w in want]), kind)
