"""The committed conformance vectors (``conformance/manifest.json``: QDQ,
QOperator, dynamic-quantization and recurrent graphs written by the JAX
package's exporters) replayed through the port on the CPU.

Each vector's outputs lie within its ``atol`` of the committed
``expected::*`` arrays and of the JAX package's executor on the same file
(TPU-mode numerics, x64 off), and every integer intermediate the walk
records -- the outputs of QuantizeLinear, QLinearMatMul, QLinearConv,
DynamicQuantizeLinear and MatMulInteger -- equals JAX's exactly.
"""
import json
import os

import jax
import numpy as np
import pytest

import numpy_quant_tpu as nq
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch import onnx as O
from numpy_quant_tpu_torch.tensor import QTensor

VECTORS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conformance")
with open(os.path.join(VECTORS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
INTEGER_OPS = ("QuantizeLinear", "QLinearMatMul", "QLinearConv",
               "DynamicQuantizeLinear", "MatMulInteger")


def test_manifest_holds_thirteen_vectors():
    assert len(MANIFEST) == 13


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["name"] for e in MANIFEST])
def test_vector_replays_through_the_port(entry):
    path = os.path.join(VECTORS, entry["model"])
    arrays = np.load(os.path.join(VECTORS, entry["arrays"]))
    inputs = [arrays[n] for n in entry["inputs"]]
    atol = entry["atol"]

    port = Model.from_onnx(O.load(path), device="cpu")
    got = port(inputs, record=True)
    with jax.enable_x64(False):
        ref = nq.Model.from_onnx(nq.onnx.load(path))
        want = ref(inputs, record=True)
    assert len(got) == len(entry["outputs"])
    for name, g, w in zip(entry["outputs"], got, want):
        g = np.asarray(g, np.float64)
        assert g.shape == np.shape(w)
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, arrays[f"expected::{name}"],
                                   rtol=0, atol=atol, err_msg=name)
        np.testing.assert_allclose(g, np.asarray(w, np.float64), rtol=0,
                                   atol=atol, err_msg=name)

    jax_values = {v.name: v for v in ref.values}
    compared = 0
    for node in port.nodes:
        if node.op not in INTEGER_OPS:
            continue
        for out in node.outputs:
            mine, theirs = out.data, jax_values[out.name].data
            if isinstance(mine, QTensor):
                assert theirs.bit_width == mine.bit_width, out.name
            np.testing.assert_array_equal(
                mine.data.numpy(), np.asarray(theirs.data), err_msg=out.name)
            compared += 1
    ops = {n.op for n in port.nodes}
    assert (compared > 0) == bool(ops & set(INTEGER_OPS))
