"""The port's trained copy-task GPT (``models/text_fixture.py``) held
against the JAX package's: the committed ``gpt_trained.npz`` (2 layers,
hidden 128, 4 heads, vocabulary 50) built through the port's GPT-2
builders, in TPU-mode numerics (x64 off).

Tolerance: zero. The full, decode-step and prefill graphs equal JAX's
``trained_gpt_*_onnx`` node for node with equal initializers;
``make_copy_batch``/``make_prompts`` draw JAX's sequences from the same
generator state. On ``make_prompts(default_rng(11), 8)`` the greedy
``generate_kv`` tokens equal JAX's, float and int8 (quantized on the port's
``decode_calibration`` stats, JAX's state installed), so the copy
accuracies are equal; the float model copies (accuracy >= 0.97, the
capstone's floor) and int8 keeps within 0.02 of it (its MAX_ACC_DROP).
"""
import importlib

import jax
import numpy as np
import pytest

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import text_fixture as JTF
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.models import text_fixture as TTF
from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                         merge_calibration_stats)
from .torch_parity import assert_same_graph, jax_state

JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")
BATCH = 8
FORMS = {"full": ("trained_gpt_onnx", dict(batch_size=2)),
         "decode": ("trained_gpt_decode_onnx", dict(batch_size=BATCH)),
         "prefill": ("trained_gpt_prefill_onnx",
                     dict(prefill_len=TTF.COPY_LEN + 1))}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.mark.parametrize("form", list(FORMS))
def test_graphs_equal_jax(form):
    name, kw = FORMS[form]
    with jax.enable_x64(False):
        jp = getattr(JTF, name)(**kw)
    tp = getattr(TTF, name)(**kw)
    assert_same_graph(tp, jp)
    np.testing.assert_array_equal(tp._wte, jp._wte)
    np.testing.assert_array_equal(tp._wpe, jp._wpe)


def test_copy_accuracy_matches_jax():
    prompts, expected = TTF.make_prompts(np.random.default_rng(11), BATCH)
    j_prompts, j_expected = JTF.make_prompts(np.random.default_rng(11),
                                             BATCH)
    np.testing.assert_array_equal(prompts, j_prompts)
    np.testing.assert_array_equal(expected, j_expected)
    np.testing.assert_array_equal(
        TTF.make_copy_batch(np.random.default_rng(3), 4),
        JTF.make_copy_batch(np.random.default_rng(3), 4))
    tp = TTF.trained_gpt_decode_onnx(batch_size=BATCH)
    wte, wpe = tp._wte, tp._wpe
    step = Model.from_onnx(tp, device="cpu")
    stats = merge_calibration_stats(*[step.calibration_stats(b) for b in
                                      decode_calibration(step, prompts, wte,
                                                         wpe)])
    with jax.enable_x64(False):
        jm = nq.Model.from_onnx(JTF.trained_gpt_decode_onnx(batch_size=BATCH))
        jq = jm.quantize(stats=stats, bit_width=8)
        j_float = JGEN.generate_kv(jm, prompts, wte, wpe, TTF.COPY_LEN)
        j_int8 = JGEN.generate_kv(jq, prompts, wte, wpe, TTF.COPY_LEN)
    tq = step.quantize(stats=stats, bit_width=8)
    load_jax_params(tq, jax_state(jq))
    got = {"float": generate_kv(step, prompts, wte, wpe, TTF.COPY_LEN),
           "int8": generate_kv(tq, prompts, wte, wpe, TTF.COPY_LEN)}
    np.testing.assert_array_equal(got["float"], j_float)
    np.testing.assert_array_equal(got["int8"], j_int8)
    acc = {k: TTF.copy_accuracy(v[:, TTF.COPY_LEN + 1:], expected)
           for k, v in got.items()}
    assert acc["float"] == JTF.copy_accuracy(
        j_float[:, TTF.COPY_LEN + 1:], expected) >= 0.97
    assert acc["int8"] >= acc["float"] - 0.02
