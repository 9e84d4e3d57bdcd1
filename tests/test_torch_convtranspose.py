"""ConvTranspose (2-D and 1-D, strided, padded, dilated, grouped) and
GroupNormalization in the port, held against the JAX package's (the
counterpart of ``tests/test_convtranspose.py``): ConvTranspose within
atol 2e-5 (XLA's dilated convolution and torch's transposed one sum in
other orders), GroupNormalization within rtol 1e-5 / atol 2e-6, and a
quantized encoder/decoder with shared stats equal in its integers."""
import jax
import numpy as np
import pytest
import torch

from numpy_quant_tpu_torch import onnx as O

from .torch_parity import (assert_integers_equal, check, graph, jax_model,
                           jax_qvalues, port_model, run_jax)

RNG = np.random.default_rng(17)


@pytest.mark.parametrize("stride,pad,opad,dil,group", [
    (1, 0, 0, 1, 1), (2, 1, 1, 1, 1), (2, 0, 0, 1, 2), (1, 2, 0, 2, 1),
    (3, 1, 2, 1, 2)])
def test_convtranspose_2d(stride, pad, opad, dil, group):
    ci, co, k = 4, 6, 3
    x = RNG.standard_normal((2, ci, 7, 7)).astype(np.float32)
    w = (RNG.standard_normal((ci, co // group, k, k)) / k).astype(np.float32)
    b = RNG.standard_normal(co).astype(np.float32)
    got = check([O.make_node("ConvTranspose", ["x", "w", "b"], ["y"],
                             strides=[stride] * 2, pads=[pad] * 4,
                             output_padding=[opad] * 2, dilations=[dil] * 2,
                             group=group, kernel_shape=[k, k])],
                {"x": x}, [O.from_array(w, "w"), O.from_array(b, "b")],
                atol=2e-5)
    want = torch.nn.functional.conv_transpose2d(
        torch.tensor(x), torch.tensor(w), torch.tensor(b), stride=stride,
        padding=pad, output_padding=opad, dilation=dil, groups=group)
    np.testing.assert_allclose(got["y"], want.numpy(), atol=1e-4)


def test_convtranspose_asymmetric_pads_and_1d():
    x = RNG.standard_normal((2, 3, 6, 5)).astype(np.float32)
    w = (RNG.standard_normal((3, 4, 3, 2)) / 2).astype(np.float32)
    check([O.make_node("ConvTranspose", ["x", "w"], ["y"], strides=[2, 1],
                       pads=[0, 1, 2, 0], kernel_shape=[3, 2])],
          {"x": x}, [O.from_array(w, "w")], atol=2e-5)
    x1 = RNG.standard_normal((2, 3, 11)).astype(np.float32)
    w1 = (RNG.standard_normal((3, 5, 4)) / 2).astype(np.float32)
    got = check([O.make_node("ConvTranspose", ["x", "w"], ["y"], strides=[2],
                             pads=[1, 1], kernel_shape=[4])],
                {"x": x1}, [O.from_array(w1, "w")], atol=2e-5)
    np.testing.assert_allclose(got["y"], torch.nn.functional.conv_transpose1d(
        torch.tensor(x1), torch.tensor(w1), stride=2, padding=1).numpy(),
        atol=1e-4)


@pytest.mark.parametrize("groups,per_group", [(2, False), (4, False),
                                              (2, True)])
def test_groupnorm(groups, per_group):
    c = 8
    x = RNG.standard_normal((3, c, 5, 5)).astype(np.float32)
    n_aff = groups if per_group else c
    got = check([O.make_node("GroupNormalization", ["x", "g", "b"], ["y"],
                             num_groups=groups, epsilon=1e-4)],
                {"x": x},
                [O.from_array(RNG.uniform(0.5, 1.5, n_aff)
                              .astype(np.float32), "g"),
                 O.from_array(RNG.standard_normal(n_aff)
                              .astype(np.float32), "b")],
                rtol=1e-5, atol=2e-6)
    assert got["y"].shape == x.shape


def test_decoder_with_convtranspose_quantized():
    ci, w0 = 3, 8
    x = RNG.standard_normal((4, ci, 8, 8)).astype(np.float32)
    inits = [O.from_array((RNG.standard_normal((w0, ci, 3, 3)) / 3)
                          .astype(np.float32), "enc_w"),
             O.from_array((RNG.standard_normal((w0, w0, 2, 2)) / 2)
                          .astype(np.float32), "up_w"),
             O.from_array(RNG.standard_normal((2, w0, 1, 1))
                          .astype(np.float32), "head_w")]
    nodes = [O.make_node("Conv", ["x", "enc_w"], ["e"], kernel_shape=[3, 3],
                         pads=[1, 1, 1, 1], strides=[2, 2]),
             O.make_node("Relu", ["e"], ["er"]),
             O.make_node("ConvTranspose", ["er", "up_w"], ["u"],
                         strides=[2, 2], kernel_shape=[2, 2]),
             O.make_node("Relu", ["u"], ["ur"]),
             O.make_node("Conv", ["ur", "head_w"], ["y"], kernel_shape=[1, 1])]
    proto = graph(nodes, {"x": x}, inits)
    port, ref = port_model(proto), jax_model(proto)
    with jax.enable_x64(False):
        stats = ref.calibration_stats([x])
    qp = port.quantize(bit_width=8, stats=stats, quantize_conv=True)
    qj = ref.quantize(bit_width=8, stats=stats, quantize_conv=True)
    got = qp([x], record=True)[0]
    assert got.shape == (4, 2, 8, 8)
    assert assert_integers_equal(qp, jax_qvalues(qj, [x])) >= 2
    np.testing.assert_allclose(got, run_jax(qj, [x])[0], atol=1e-5)
