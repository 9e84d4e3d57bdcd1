"""The port's quantization-aware training (``qat.py``: ``_fq``,
``fake_quant_forward``, ``qat_quantize`` and ``Model.qat_quantize``), held
against the JAX package's ``qat.py`` in TPU-mode numerics (x64 off) on the
reference MLP (``mlp.onnx``, 600 circle points) and JAX's tiny BERT
(hidden 32, 2 layers, 8 ids of 8 tokens).

Tolerances: ``_fq``'s forward and straight-through gradient equal JAX's
``_fq`` and ``jax.grad`` bit for bit on a seeded grid that crosses both
saturation bounds, for both rounding forms, at 2, 4, 8 and 32 bits, per
tensor and per channel, and at scale 0. ``fake_quant_forward`` lies within
1e-5 * max|y| of JAX's. QAT is noisy by design (a weight on a rounding
boundary moves the loss by a level), so the training runs are compared on
the step-0 loss, within 1e-5 relative of JAX's, and then on the rules of
JAX's own tests (tests/test_qat.py): the loss falls, QAT lands closer to
float than PTQ, the float model is untouched, ``train_filter`` keeps the
filtered payload at PTQ's integers, accuracy is at least PTQ's, and
BERT's int64 ids bind as static inputs under W4A8 with every MatMul
weight at 4 bits. The 60-step 3-bit ViT capstone runs on the card
(chip_smoke.py phase 22), not here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu import qat as JQ
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import qat as TQ
from numpy_quant_tpu_torch.graph import Constant
from numpy_quant_tpu_torch.models.mlp import MLP_PATH, load_mlp, two_circles
from numpy_quant_tpu_torch.tensor import QTensor


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def circles():
    x, y = two_circles(n_samples=600, noise=0.03, seed=3)
    return x, y.astype(np.int64)


def _mlp():
    return Model.from_onnx(load_mlp(), device="cpu")


def _jax_mlp():
    return nq.Model.from_onnx(nq.onnx.load(MLP_PATH))


def _grid(rng, scale, zp, bits):
    """Values across the representable range and past both bounds, with
    the bounds themselves, zeros and half steps."""
    lo, hi = -2.0 ** (bits - 1), 2.0 ** (bits - 1) - 1
    s = float(np.max(scale)) if np.max(scale) > 0 else 1.0
    z = 0.0 if zp is None else float(zp)
    span = (hi - lo) * s
    x = rng.uniform(-span, span, 2048).astype(np.float32)
    edges = np.array([(lo - z) * s, (hi - z) * s, (lo - z - 0.5) * s,
                      (hi - z + 0.5) * s, 0.0, 0.5 * s, -0.5 * s, 1e-9],
                     np.float32)
    return np.concatenate([x, edges]).astype(np.float32)


@pytest.mark.parametrize("rint_first", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8, 32])
@pytest.mark.parametrize("qp", ["sym", "asym", "zero", "per_channel"])
def test_fq_forward_and_gradient_equal_jax(rint_first, bits, qp):
    rng = np.random.default_rng(bits * 2 + rint_first)
    scale, zp = {"sym": (np.float32(0.0371), None),
                 "asym": (np.float32(0.013), 3),
                 "zero": (np.float32(0.0), None),
                 "per_channel": (np.array([[0.02, 0.5, 0.0, 0.11]],
                                          np.float32), None)}[qp]
    x = _grid(rng, scale, zp, bits)
    if qp == "per_channel":
        x = x[:2056].reshape(-1, 4)
    weights = np.arange(x.size, dtype=np.float32).reshape(x.shape)
    want = np.asarray(JQ._fq(jnp.asarray(x), scale, zp, bits, rint_first))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        JQ._fq(v, scale, zp, bits, rint_first) * weights))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TQ._fq(xt, scale, zp, bits, rint_first)
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)


def test_fake_quant_forward_matches_jax(circles):
    x = circles[0][:128]
    tm, jm = _mlp(), _jax_mlp()
    stats = tm.calibration_stats([x])
    got = TQ.fake_quant_forward(tm, tm.quantize(bit_width=8, stats=stats),
                                [x])[0]
    want = np.asarray(JQ.fake_quant_forward(
        jm, jm.quantize(bit_width=8, stats=stats), [x])[0])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    q = tm.quantize([x], bit_width=8)
    np.testing.assert_allclose(got, q([x])[0], atol=0.02)


def test_qat_beats_ptq_at_low_bits(circles):
    """4-bit MLP, self-distilled: the step-0 loss matches JAX's, the loss
    falls below 0.8 x its first value, QAT's MSE to float beats PTQ's, and
    the float model is untouched."""
    x, _ = circles
    tm = _mlp()
    f_out = tm([x])[0]
    ptq = tm.quantize([x], bit_width=4)
    qat = tm.qat_quantize([x], bit_width=4, steps=150, lr=3e-3)
    hist = qat.qat_loss_history
    assert hist.dtype == np.float32 and hist.shape == (150,)
    assert hist.min() < hist[0] * 0.8
    j_hist = _jax_mlp().qat_quantize([x], bit_width=4, steps=1,
                                     lr=3e-3).qat_loss_history
    np.testing.assert_allclose(hist[0], j_hist[0], rtol=1e-5)
    assert np.mean((qat([x])[0] - f_out) ** 2) \
        < np.mean((ptq([x])[0] - f_out) ** 2)
    np.testing.assert_array_equal(tm([x])[0], f_out)


def test_qat_loss_fn_and_train_filter(circles):
    """An explicit loss over the output tensors, training fc2 only: fc1's
    payload stays PTQ's integers, fc2's moves, accuracy is at least PTQ's;
    integer labels switch to the cross-entropy loss, whose step-0 value
    matches JAX's."""
    x, y = circles
    yt = torch.from_numpy(y.astype(np.float32))

    def loss_fn(outs):
        p = torch.clamp(outs[0][:, 0], 1e-6, 1 - 1e-6)
        return -torch.mean(yt * torch.log(p) + (1 - yt) * torch.log(1 - p))

    tm = _mlp()
    ptq = tm.quantize([x], bit_width=4)
    qat = tm.qat_quantize([x], bit_width=4, steps=120, lr=3e-3,
                          loss_fn=loss_fn,
                          train_filter=lambda n: n.startswith("fc2."))
    assert qat.qat_loss_history.min() < qat.qat_loss_history[0]
    got = {v.name: v.data.data for v in qat.values
           if isinstance(v, Constant)}
    ref = {v.name: v.data.data for v in ptq.values
           if isinstance(v, Constant)}
    np.testing.assert_array_equal(got["fc1.weight"], ref["fc1.weight"])
    assert not torch.equal(got["fc2.weight"], ref["fc2.weight"])

    def acc(m):
        return ((m([x])[0][:, 0] > 0.5) == y).mean()
    assert acc(qat) >= acc(ptq)

    ce = tm.qat_quantize([x], bit_width=4, steps=1, labels=y)
    j_ce = _jax_mlp().qat_quantize([x], bit_width=4, steps=1, labels=y)
    np.testing.assert_allclose(ce.qat_loss_history, j_ce.qat_loss_history,
                               rtol=1e-5)


def test_qat_int64_inputs_and_mixed_width():
    """JAX's tiny BERT: int64 ids bind as static inputs of the training
    walk; W4A8 reaches both quantize calls, so every MatMul weight is 4
    bits afterwards; the loss falls and the output is finite."""
    from numpy_quant_tpu.models.text import bert_text_classifier as j_bert
    from numpy_quant_tpu_torch.models.text import bert_text_classifier
    from .test_torch_text import port_config

    m = j_bert(batch_size=8, seq_len=8, seed=3)._torch_module
    w = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()
         if not k.endswith(("position_ids", "token_type_ids"))}
    model = Model.from_onnx(bert_text_classifier(
        w, port_config(m.config), batch_size=8, seq_len=8), device="cpu")
    ids = np.random.default_rng(17).integers(0, 96, (8, 8)).astype(np.int64)
    qat = model.qat_quantize([ids], bit_width=8, weight_bit_width=4,
                             steps=40, lr=1e-3)
    assert qat.qat_loss_history.min() < qat.qat_loss_history[0]
    out = qat([ids])[0]
    assert out.shape == (8, 4) and np.isfinite(out).all()
    widths = {v.data.bit_width for v in qat.values
              if isinstance(v, Constant) and isinstance(v.data, QTensor)
              and v.name.endswith("weight_t")}
    assert widths == {4}
