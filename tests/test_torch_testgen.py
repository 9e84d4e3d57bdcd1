"""The port's test-graph generators (``models/testgen.py``) and MLP
builders (``models/mlp.py``: ``build_mlp_onnx``, ``get_torch_model``,
``export_mlp``) against the JAX package's: every proto serializes to the
same bytes for the same arguments; ``build_mlp_onnx`` fed the committed
``mlp.onnx``'s weights gives that file byte for byte; ``export_mlp(seed=1)``
trains the same torch module on the same points (``two_circles`` against
sklearn's make_circles) and gives JAX's proto byte for byte, so its
weights equal JAX's exactly.
"""
import numpy as np
import pytest

from numpy_quant_tpu.models import mlp as JMLP
from numpy_quant_tpu.models import testgen as JG
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.models import mlp as TMLP
from numpy_quant_tpu_torch.models import testgen as TG

CASES = {
    "gemm": ("gemm", (3, 4, 5, 0), {}),
    "gemm_alpha_beta": ("gemm", (2, 6, 3, 7), dict(alpha=0.5, beta=2.0)),
    "matmul": ("matmul", ((2, 1, 3, 4), (1, 5, 4, 6)), {}),
    "conv": ("conv", (2, 3, (9, 7), 4, (3, 2), (1, 0, 2, 1), (2, 1), 5), {}),
    "expand": ("expand", (), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_testgen_protos_equal_jax(case):
    fn, args, kw = CASES[case]
    got = getattr(TG, fn)(*args, **kw).SerializeToString()
    assert got == getattr(JG, fn)(*args, **kw).SerializeToString()


def test_shapes_broadcastable():
    for a, b in (((2, 1, 3), (4, 3)), ((5, 2), (3, 2)), ((1,), (7, 1))):
        assert TG.shapes_broadcastable(a, b) == JG.shapes_broadcastable(a, b)


def test_build_mlp_onnx_gives_the_committed_file():
    w = {t.name: O.to_array(t) for t in TMLP.load_mlp().graph.initializer}
    args = (w["fc1.weight"], w["fc1.bias"], w["fc2.weight"], w["fc2.bias"])
    got = TMLP.build_mlp_onnx(*args).SerializeToString()
    assert got == TMLP.MLP_PATH.read_bytes()
    assert got == JMLP.build_mlp_onnx(*args).SerializeToString()
    fixed = TMLP.build_mlp_onnx(*args, dynamic_batch=False)
    assert fixed.SerializeToString() == JMLP.build_mlp_onnx(
        *args, dynamic_batch=False).SerializeToString()


def test_two_circles_are_make_circles():
    from sklearn.datasets import make_circles
    x, y = make_circles(n_samples=1000, noise=0.03, random_state=1)
    tx, ty = TMLP.two_circles(1000, 0.03, seed=1)
    np.testing.assert_array_equal(tx, x.astype(np.float32))
    np.testing.assert_array_equal(ty, y)


def test_export_mlp_equals_jax(tmp_path):
    got = TMLP.export_mlp(tmp_path / "mlp.onnx", seed=1)
    want = JMLP.export_mlp(seed=1)
    assert got.SerializeToString() == want.SerializeToString()
    assert (tmp_path / "mlp.onnx").read_bytes() == got.SerializeToString()
    _, acc = TMLP.get_torch_model(epochs=10, seed=2)
    assert 0.0 <= acc <= 1.0
