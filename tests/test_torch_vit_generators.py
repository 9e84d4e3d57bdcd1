"""The port's five ViT sub-graph generators (``models/vit.py``:
``vit_self_attention``, ``vit_embedding``, ``vit_layer``, ``vit_pooler``,
``vit``) held against the JAX package's.

* Built from the state dict of JAX's seeded ``transformers`` module
  (``proto._torch_module.state_dict()``), each graph serializes to the same
  bytes as JAX's.
* JAX's ``tests/test_vit.py`` cases run on both packages at their shapes:
  float outputs against the HF module's own forward at JAX's tolerances
  (atol 1e-6, 1e-4 end to end) and against JAX's forward, the quantized
  error bounds (mean |Δ| <= 0.01 and 0.1), and the int8 intermediates of the
  quantized self-attention equal to JAX's from the same stats.
* ``vit_part_weights`` draws each sub-module's keys and shapes.
"""
import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import vit as JV
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.graph import Variable
from numpy_quant_tpu_torch.models import vit as TV
from numpy_quant_tpu_torch.tensor import QTensor

# JAX's tests/test_vit.py shapes, one per generator
CASES = {
    "self_attention": ((1, 10, 16, 4), (1, 10, 16)),
    "embedding": ((1, 16, 4, 8), (1, 3, 16, 16)),
    "layer": ((1, 16, 4, 22, 8, 2), (1, 17, 8)),
    "pooler": ((1, 16, 4, 8), (1, 17, 8)),
    "vit": ((2, 16, 4, 22, 8, 2), (2, 3, 16, 16)),
}
GEN = {"self_attention": "vit_self_attention", "embedding": "vit_embedding",
       "layer": "vit_layer", "pooler": "vit_pooler", "vit": "vit"}
# float tolerance against the HF module (JAX's test_vit.py)
ATOL = {"vit": 1e-4}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _pair(kind: str, args=None):
    """(JAX proto, port proto from the JAX module's state dict, input)."""
    args = args or CASES[kind][0]
    jproto = getattr(JV, GEN[kind])(*args)
    sd = {k: v.detach().numpy() for k, v in
          jproto._torch_module.state_dict().items()}
    tproto = getattr(TV, GEN[kind])(*args, weights=sd)
    x = np.random.default_rng(len(kind)).normal(
        size=CASES[kind][1]).astype(np.float32)
    return jproto, tproto, x


@pytest.mark.parametrize("kind", list(CASES))
def test_graph_bytes_equal_jax(kind):
    jproto, tproto, _ = _pair(kind)
    assert tproto.SerializeToString() == jproto.SerializeToString()


@pytest.mark.parametrize("kind", list(CASES))
def test_float_matches_hf_and_jax(kind):
    jproto, tproto, x = _pair(kind)
    with torch.no_grad():
        want = jproto._torch_module(torch.tensor(x))
    if kind == "vit":
        want = want.last_hidden_state
    if isinstance(want, tuple):
        want = want[0]
    got = Model.from_onnx(tproto, device="cpu")([x])[0]
    jy = nq.Model.from_onnx(jproto)([x])[0]
    np.testing.assert_allclose(got, want.numpy(), atol=ATOL.get(kind, 1e-6))
    np.testing.assert_allclose(got, jy, atol=1e-6)


def test_self_attention_quantized_matches_jax():
    """JAX's test_vit_self_attention_quantized bound (mean error <= 0.01)
    on the port, and the port's int8 intermediates equal JAX's from the same
    calibration stats."""
    jproto, tproto, x = _pair("self_attention")
    jm = nq.Model.from_onnx(jproto)
    stats = jm.calibration_stats([x])
    jq = jm.quantize(stats=stats, bit_width=8)
    tm = Model.from_onnx(tproto, device="cpu")
    tq = tm.quantize(stats=stats, bit_width=8)
    ty = tq([x], record=True)[0]
    assert np.mean(np.abs(ty - tm([x])[0])) <= 0.01
    jy = jq([x], record=True)[0]
    jdata = {v.name: v.data for v in jq.values}
    checked = 0
    for v in tq.values:
        if isinstance(v, Variable) and isinstance(v.data, QTensor):
            np.testing.assert_array_equal(
                v.data.data.numpy(), np.asarray(jdata[v.name].data), v.name)
            checked += 1
    assert checked >= 5
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6)


def test_vit_quantized_small_error_bound():
    """JAX's test_vit_quantized_small on the port at its shapes (8 images of
    96 px, hidden 120, 4 heads, 2 layers): mean |int8 - float| <= 0.1, the
    profile's quantize bucket present; the int8 outputs agree with JAX's
    from the same stats within 1e-2 of their largest."""
    jproto, tproto, _ = _pair("vit", (8, 96, 16, 156, 120, 4))
    x = np.random.default_rng(0).normal(size=(8, 3, 96, 96)) \
        .astype(np.float32)
    jm = nq.Model.from_onnx(jproto)
    stats = jm.calibration_stats([x])
    tm = Model.from_onnx(tproto, device="cpu")
    tq = tm.quantize(stats=stats, bit_width=8)
    out, _ = tm([x], profile=True)
    qout, prof = tq([x], profile=True)
    assert np.mean(np.abs(qout[0] - out[0])) <= 0.1
    assert "TinyqQuant" in prof and prof["MatMul"] >= 0.0
    jy = jm.quantize(stats=stats, bit_width=8)([x])[0]
    np.testing.assert_allclose(qout[0], jy, rtol=0,
                               atol=1e-2 * float(np.abs(jy).max()))


@pytest.mark.parametrize("kind", list(CASES))
def test_part_weights_follow_the_module_layout(kind):
    """The seeded draw has the sub-module's own keys and shapes, and the
    generator builds from it with no state dict given."""
    jproto, _, x = _pair(kind)
    hf = {k: tuple(v.shape) for k, v in
          jproto._torch_module.state_dict().items()}
    args = CASES[kind][0]
    cfg = {"self_attention": dict(hidden_size=16, num_attention_heads=4),
           "embedding": dict(image_size=16, patch_size=4, hidden_size=8),
           "layer": dict(image_size=16, patch_size=4, hidden_size=8,
                         intermediate_size=22, num_attention_heads=2),
           "pooler": dict(hidden_size=8),
           "vit": dict(image_size=16, patch_size=4, hidden_size=8,
                       intermediate_size=22, num_attention_heads=2,
                       num_hidden_layers=2)}[kind]
    part = "embeddings" if kind == "embedding" else kind
    w = TV.vit_part_weights(part, cfg, seed=3)
    assert {k: v.shape for k, v in w.items()} == hf
    drawn = getattr(TV, GEN[kind])(*args, seed=3)
    assert drawn.SerializeToString() == \
        getattr(TV, GEN[kind])(*args, weights=w).SerializeToString()
    y = Model.from_onnx(drawn, device="cpu")([x])[0]
    assert np.isfinite(y).all()
