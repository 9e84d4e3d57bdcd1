"""The port's im2col helpers (``ops/conv.py``: ``extract_sliding_windows_nhwc``
and ``conv2d_im2col``) held against the JAX package's on JAX's
``tests/test_conv2d.py`` case and a few other windows: the patches equal
JAX's bit for bit, and the im2col conv equals JAX's within 1e-5 (another
product order) and the port's direct conv within JAX's own 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpy_quant_tpu.ops import conv as JC
from numpy_quant_tpu_torch.ops import conv as TC

# (batch, channels, input hw, out channels, kernel, pads, strides); the
# first is JAX's test_conv2d.py::_case
CASES = [
    (2, 3, (9, 10), 2, (3, 2), (0, 2, 2, 1), (2, 1)),
    (1, 4, (8, 8), 5, (2, 2), (0, 0, 0, 0), (2, 2)),
    (2, 2, (7, 5), 3, (3, 3), (1, 1, 1, 1), (1, 1)),
    (1, 3, (6, 9), 2, (1, 4), (2, 0, 0, 3), (3, 2)),
]


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _case(i):
    b, c, hw, oc, k, pads, strides = CASES[i]
    rng = np.random.default_rng(i)
    x = rng.normal(size=(b, c, *hw)).astype(np.float32)
    w = rng.normal(size=(oc, c, *k)).astype(np.float32)
    return x, w, pads, strides


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sliding_windows_equal_jax(i):
    x, w, pads, strides = _case(i)
    x_t = x.transpose(0, 2, 3, 1)
    k = w.shape[2:]
    want = np.asarray(JC.extract_sliding_windows_nhwc(
        jnp.asarray(x_t), k, pads, strides))
    got = TC.extract_sliding_windows_nhwc(torch.from_numpy(x_t), k, pads,
                                          strides).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_conv2d_im2col_matches_jax_and_direct(i):
    x, w, pads, strides = _case(i)
    x_t = x.transpose(0, 2, 3, 1)
    w_t = w.transpose(2, 3, 1, 0)
    want = np.asarray(JC.conv2d_im2col(jnp.asarray(x_t), jnp.asarray(w_t),
                                       pads, strides, jnp.matmul))
    got = TC.conv2d_im2col(torch.from_numpy(x_t), torch.from_numpy(w_t),
                           pads, strides, torch.matmul)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    direct = TC.conv2d_nchw(torch.from_numpy(x), torch.from_numpy(w), None,
                            pads, strides)
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(),
                               direct.numpy(), atol=1e-4)


def test_conv2d_im2col_integer_matmul_is_exact():
    """With an exact integer product the im2col conv equals the float64
    direct conv of the same integers."""
    x, w, pads, strides = _case(0)
    xi = np.rint(x * 20).astype(np.float32)
    wi = np.rint(w * 20).astype(np.float32)
    got = TC.conv2d_im2col(
        torch.from_numpy(xi.transpose(0, 2, 3, 1)),
        torch.from_numpy(wi.transpose(2, 3, 1, 0)), pads, strides,
        lambda a, b: torch.matmul(a.double(), b.double()))
    want = TC.conv2d_nchw(torch.from_numpy(xi).double(),
                          torch.from_numpy(wi).double(), None, pads, strides)
    np.testing.assert_array_equal(got.permute(0, 3, 1, 2).numpy(),
                                  want.numpy())
