"""The port's trained fixtures held against the JAX package's: the graphs
its own builders make from the committed ``.npz`` state dicts equal the
JAX package's (built through ``transformers`` modules) node for node with
equal initializer bytes; ``make_batch`` and ``make_modsum_batch`` draw the
same bytes from the same generator state; the float accuracy of the small
trained ViT and of the modular-sum GPT equals JAX's (logits within 1e-4,
labels equal), in TPU-mode numerics (x64 off)."""
import jax
import numpy as np
import pytest

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import fixtures as JF
from numpy_quant_tpu.models import modsum_fixture as JM
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import onnx as T_ONNX
from numpy_quant_tpu_torch.models import fixtures as TF
from numpy_quant_tpu_torch.models import modsum_fixture as TM


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _nodes(g, codec):
    out = []
    for n in g.node:
        attrs = {}
        for a in n.attribute:
            val = codec.get_attribute_value(a)
            if isinstance(val, codec.TensorProto):
                arr = codec.to_array(val)
                val = (arr.dtype.str, arr.shape, arr.tobytes())
            attrs[a.name] = val
        out.append((n.op_type, n.name, list(n.input), list(n.output), attrs))
    return out


def _inits(g, codec):
    return [(t.name, codec.to_array(t).dtype.str, codec.to_array(t).shape,
             codec.to_array(t).tobytes()) for t in g.initializer]


def _vis(vs):
    return [(v.name, nq.onnx.value_info_shape(v)) for v in vs]


GRAPHS = {
    "vit": (lambda: JF.trained_vit_onnx(batch_size=4),
            lambda: TF.trained_vit_onnx(batch_size=4)),
    "vit_base": (lambda: JF.trained_vit_base_onnx(batch_size=2),
                 lambda: TF.trained_vit_base_onnx(batch_size=2)),
    "modsum": (lambda: JM.trained_modsum_onnx(batch_size=3),
               lambda: TM.trained_modsum_onnx(batch_size=3)),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fixture_graph_equals_jax(name):
    jmake, tmake = GRAPHS[name]
    jp, tp = jmake(), tmake()
    assert _nodes(tp.graph, T_ONNX) == _nodes(jp.graph, nq.onnx)
    assert _inits(tp.graph, T_ONNX) == _inits(jp.graph, nq.onnx)
    assert _vis(tp.graph.input) == _vis(jp.graph.input)
    assert _vis(tp.graph.output) == _vis(jp.graph.output)
    if name == "modsum":
        np.testing.assert_array_equal(tp._wte, jp._wte)
        np.testing.assert_array_equal(tp._wpe, jp._wpe)


@pytest.mark.parametrize("n,size", [(5, TF.IMAGE_SIZE),
                                    (2, TF.BASE_IMAGE_SIZE)])
def test_make_batch_byte_equal(n, size):
    jx, jy = JF.make_batch(np.random.default_rng(3), n, size)
    tx, ty = TF.make_batch(np.random.default_rng(3), n, size)
    assert tx.tobytes() == jx.tobytes()
    assert ty.tobytes() == jy.tobytes()


def test_make_modsum_batch_byte_equal():
    j = JM.make_modsum_batch(np.random.default_rng(17), 9)
    t = TM.make_modsum_batch(np.random.default_rng(17), 9)
    assert t.tobytes() == j.tobytes()
    assert (TM.P, TM.K_TERMS, TM.SEQ_LEN) == (JM.P, JM.K_TERMS, JM.SEQ_LEN)
    np.testing.assert_array_equal(t[:, 1::2], np.cumsum(t[:, 0::2], 1) % TM.P)


def test_config_dicts_follow_jax():
    jc, jb = JF.fixture_config(), JF.base_fixture_config()
    for cfg, hf in ((TF.FIXTURE_CONFIG, jc), (TF.BASE_FIXTURE_CONFIG, jb)):
        assert {k: getattr(hf, k) for k in cfg} == cfg
    gc = JM.fixture_config()
    assert {k: getattr(gc, k) for k in TM.MODSUM_CONFIG} == TM.MODSUM_CONFIG


def test_trained_vit_float_accuracy_equals_jax():
    x, y = TF.make_batch(np.random.default_rng(99), 32)
    jy = nq.Model.from_onnx(JF.trained_vit_onnx(batch_size=32))([x])[0]
    ty = Model.from_onnx(TF.trained_vit_onnx(batch_size=32),
                         device="cpu")([x])[0]
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ty.argmax(1), jy.argmax(1))
    acc = float((ty.argmax(1) == y).mean())
    print(f"trained ViT float accuracy {acc}")
    assert acc >= 0.95


def test_modsum_float_accuracy_equals_jax():
    seqs = TM.make_modsum_batch(np.random.default_rng(5), 32)
    tp = TM.trained_modsum_onnx(batch_size=32)
    x = np.take(tp._wte, seqs, axis=0).astype(np.float32)
    jy = nq.Model.from_onnx(JM.trained_modsum_onnx(batch_size=32))([x])[0]
    ty = Model.from_onnx(tp, device="cpu")([x])[0]
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-4)
    acc_t, acc_j = TM.modsum_accuracy(ty, seqs), JM.modsum_accuracy(jy, seqs)
    print(f"modsum float accuracy port {acc_t} jax {acc_j}")
    assert acc_t == acc_j and acc_t >= 0.999
