"""Programmatic ONNX test-graph generators.

Port of ``numpy_quant_tpu/models/testgen.py``: the reference's handmade
test graphs -- gemm (with the optional alpha/beta attributes),
(broadcast-batched) matmul, conv with asymmetric pads/strides, and expand
-- built with the port's own ONNX builder. For the same arguments each
proto serializes to the bytes the JAX package's generator gives.
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O


def shapes_broadcastable(shape_a, shape_b) -> bool:
    return all((m == n) or (m == 1) or (n == 1)
               for m, n in zip(shape_a[::-1], shape_b[::-1]))


def gemm(k: int, m: int, n: int, random_seed: int,
         alpha: float = None, beta: float = None) -> O.ModelProto:
    """[k,m] @ [m,n] + [n]. reference: models/test.py:19-57.
    alpha/beta are optional Gemm attributes (spec-correct support is a
    deliberate deviation; the reference ignores them, model.py:122-131)."""
    rng = np.random.default_rng(random_seed)
    inp = O.make_tensor_value_info("input", O.TensorProto.FLOAT, [k, m])
    out = O.make_tensor_value_info("output", O.TensorProto.FLOAT, [k, n])
    weight = O.from_array(rng.normal(size=(m, n)).astype(np.float32), "weight")
    bias = O.from_array(rng.normal(size=n).astype(np.float32), "bias")
    attrs = {}
    if alpha is not None:
        attrs["alpha"] = float(alpha)
    if beta is not None:
        attrs["beta"] = float(beta)
    node = O.make_node("Gemm", ["input", "weight", "bias"], ["output"],
                       name="Gemm", **attrs)
    graph = O.make_graph([node], "Gemm", [inp], [out],
                         initializer=[weight, bias])
    return O.make_model(graph, producer_name="numpy-quant-tpu-test",
                        opset_imports=[O.make_opsetid("", 13)])


def matmul(a_shape: tuple, b_shape: tuple) -> O.ModelProto:
    """Broadcast-batched MatMul. reference: models/test.py:60-96."""
    assert len(a_shape) > 2 and len(b_shape) > 2
    assert a_shape[-1] == b_shape[-2]
    assert shapes_broadcastable(a_shape[:-2], b_shape[:-2])
    out_shape = (tuple(np.broadcast_shapes(a_shape[:-2], b_shape[:-2]))
                 + a_shape[-2:-1] + b_shape[-1:])
    a = O.make_tensor_value_info("input_a", O.TensorProto.FLOAT, list(a_shape))
    b = O.make_tensor_value_info("input_b", O.TensorProto.FLOAT, list(b_shape))
    y = O.make_tensor_value_info("output", O.TensorProto.FLOAT, list(out_shape))
    node = O.make_node("MatMul", ["input_a", "input_b"], ["output"],
                       name="MatMul")
    graph = O.make_graph([node], "MatMul", [a, b], [y])
    return O.make_model(graph, producer_name="numpy-quant-tpu-test",
                        opset_imports=[O.make_opsetid("", 13)])


def conv(b: int, c: int, inp_shape: tuple, out_c: int, kernel_shape: tuple,
         pads: tuple, strides: tuple, random_seed: int) -> O.ModelProto:
    """Conv with asymmetric pads/strides. reference: models/test.py:99-151."""
    rng = np.random.default_rng(random_seed)
    out_h = (inp_shape[0] - kernel_shape[0] + pads[0] + pads[2]) // strides[0] + 1
    out_w = (inp_shape[1] - kernel_shape[1] + pads[1] + pads[3]) // strides[1] + 1
    inp = O.make_tensor_value_info("input", O.TensorProto.FLOAT,
                                   [b, c, *inp_shape])
    out = O.make_tensor_value_info("output", O.TensorProto.FLOAT,
                                   [b, out_c, out_h, out_w])
    weight = O.from_array(
        rng.normal(size=(out_c, c, *kernel_shape)).astype(np.float32), "weight")
    bias = O.from_array(rng.normal(size=out_c).astype(np.float32), "bias")
    node = O.make_node("Conv", ["input", "weight", "bias"], ["output"],
                       name="Conv", kernel_shape=list(kernel_shape),
                       pads=list(pads), strides=list(strides))
    graph = O.make_graph([node], "Conv", [inp], [out],
                         initializer=[weight, bias])
    return O.make_model(graph, producer_name="numpy-quant-tpu-test",
                        opset_imports=[O.make_opsetid("", 13)])


def expand() -> O.ModelProto:
    """Expand with a runtime shape input. reference: models/test.py:154-181."""
    inp = O.make_tensor_value_info("input", O.TensorProto.FLOAT, [1, 1, 8])
    shape = O.make_tensor_value_info("shape", O.TensorProto.INT64, [3])
    out = O.make_tensor_value_info("output", O.TensorProto.FLOAT, [1, 1, 8])
    node = O.make_node("Expand", ["input", "shape"], ["output"], name="Expand")
    graph = O.make_graph([node], "Expand", [inp, shape], [out])
    return O.make_model(graph, producer_name="numpy-quant-tpu-test",
                        opset_imports=[O.make_opsetid("", 13)])
