"""Dynamic quantization: integer matmuls with run-time activation scales;
port of ``numpy_quant_tpu/dynamic.py``.

No calibration data: weights quantize symmetrically at build time, and
each matmul's float input quantizes on the fly with scales from the
actual batch (per tensor, or per last-axis row), an int8 product, and the
zero-point-corrected dequantize -- the ``DynamicMatMul`` op
(``ops/interop.py``), torch ops in JAX's ``rint(clip(x / s + zp))`` order.

Build-time rewrite (:func:`quantize_dynamic`):

- ``MatMul`` whose rhs is a float 2-D weight -> ``DynamicMatMul`` with a
  symmetric QTensor weight (per tensor, or per channel with
  ``per_channel_weights``);
- ``Gemm`` -> ``DynamicMatMul`` + float-bias ``Add``: alpha and transB
  fold into the stored weight, beta into the stored bias;
- activation x activation matmuls stay float, as in ORT's dynamic mode.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import Constant, Node, Variable
from .model import Model
from .quantization import per_channel_scales, quant_parameters
from .tensor import FTensor, QTensor, quantize_tensor


class DynamicQModel(Model):
    """Executor of a dynamically quantized graph: the float executor, the
    integer work in the DynamicMatMul op."""

    def __init__(self, nodes, values, inputs, outputs, bit_width: int,
                 granularity: str, device):
        super().__init__(nodes, values, inputs, outputs, device)
        self.bit_width = bit_width
        self.granularity = granularity


def _quantize_weight(arr: np.ndarray, bit_width: int, per_channel: bool,
                     device) -> QTensor:
    """Symmetric quantization of a host float32 weight (per output channel
    of a 2-D [K, N] weight, else per tensor), its payload on ``device``."""
    if per_channel and arr.ndim == 2:
        scale = per_channel_scales(arr, bit_width, axis=1)  # [1, N]
    else:
        # the global min/max clamped to include 0 (tensor_min_max)
        zero = np.float32(0.0)
        scale, _ = quant_parameters(np.minimum(arr.min(), zero),
                                    np.maximum(arr.max(), zero), bit_width,
                                    asymmetric=False)
    t = FTensor(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
    return quantize_tensor(t, bit_width, scale, None)


def quantize_dynamic(model: Model, bit_width: int = 8,
                     weight_bit_width: int = None,
                     per_channel_weights: bool = False,
                     granularity: str = "row") -> DynamicQModel:
    """Rewrite ``model`` for dynamic quantization (no calibration data).

    ``granularity``: "row" (default) computes one scale per last-axis
    slice of each matmul input, "tensor" one for the whole input.
    ``weight_bit_width``: quantize weights below the activation width;
    ``per_channel_weights``: per-output-channel symmetric weight scales."""
    if granularity not in ("row", "tensor"):
        raise ValueError(f"granularity {granularity!r} not in (row, tensor)")
    wbw = weight_bit_width if weight_bit_width is not None else bit_width
    dev = model.device

    def is_dyn_weight(value) -> bool:
        """A float 2-D constant consumed only as a matmul weight (MatMul
        rhs / Gemm B): the exclusivity rule of static quantize()."""
        if not isinstance(value, Constant) \
                or not isinstance(value.data, FTensor) \
                or value.data.data.ndim != 2:
            return False
        return bool(value.outputs) and all(
            n.op in ("MatMul", "Gemm") and len(n.inputs) > 1
            and n.inputs[1] is value for n in value.outputs)

    def host(value) -> np.ndarray:
        return value.data.data.to("cpu", torch.float32).numpy()

    new_values: dict[str, object] = {}
    for value in model.values:
        if isinstance(value, Constant):
            if is_dyn_weight(value) and any(
                    n.op == "MatMul" for n in value.outputs):
                data = _quantize_weight(host(value), wbw,
                                        per_channel_weights, dev)
            else:
                data = value.data.copy()
                if getattr(value.data, "host", None) is not None:
                    data.host = value.data.host
            new_values[value.name] = Constant(value.name, [], data)
        else:
            v = Variable(value.name, [], [], None)
            v.shape_hint = getattr(value, "shape_hint", None)
            v.dtype_hint = getattr(value, "dtype_hint", None)
            new_values[value.name] = v

    dyn_attrs = {"bit_width": bit_width, "granularity": granularity}
    new_nodes: list[Node] = []
    for node in model.nodes:
        ins = [None if v is None else new_values[v.name] for v in node.inputs]
        outs = [new_values[o.name] for o in node.outputs]
        if node.op == "MatMul" and is_dyn_weight(node.inputs[1]):
            new_nodes.append(Node(node.name, "DynamicMatMul",
                                  dict(dyn_attrs), ins, outs))
        elif node.op == "Gemm" and is_dyn_weight(node.inputs[1]) \
                and not node.attrs.get("transA"):
            # fold alpha/transB into a fresh weight, beta into the bias
            W = host(node.inputs[1])
            if node.attrs.get("transB"):
                W = np.ascontiguousarray(W.T)
            alpha = np.float32(node.attrs.get("alpha", 1.0))
            if float(alpha) != 1.0:
                W = W * alpha
            w_const = Constant(f"{node.name}/dyn_w", [], _quantize_weight(
                W, wbw, per_channel_weights, dev))
            new_values[w_const.name] = w_const
            bias = node.inputs[2] if len(node.inputs) > 2 else None
            beta = np.float32(node.attrs.get("beta", 1.0))
            if bias is None or float(beta) == 0.0:
                new_nodes.append(Node(node.name, "DynamicMatMul",
                                      dict(dyn_attrs), [ins[0], w_const],
                                      outs))
                continue
            mm_out = Variable(f"{node.name}/dyn_mm_out", [], [], None)
            new_values[mm_out.name] = mm_out
            if isinstance(bias, Constant) and float(beta) != 1.0:
                b_const = Constant(f"{node.name}/dyn_bias", [], FTensor(
                    torch.from_numpy(host(bias) * beta).to(dev)))
                new_values[b_const.name] = b_const
                b_in = b_const
            else:
                if float(beta) != 1.0:
                    raise NotImplementedError(
                        "dynamic Gemm with non-constant bias and beta != 1")
                b_in = new_values[bias.name]
            new_nodes.append(Node(node.name, "DynamicMatMul",
                                  dict(dyn_attrs), [ins[0], w_const],
                                  [mm_out]))
            new_nodes.append(Node(f"{node.name}/dyn_add", "Add", {},
                                  [mm_out, b_in], outs))
        else:
            new_nodes.append(Node(node.name, node.op, dict(node.attrs),
                                  ins, outs))

    for node in new_nodes:
        for v in node.inputs:
            if v is not None:
                v.outputs.append(node)
        for o in node.outputs:
            o.inputs.append(node)

    # prune the constants the Gemm folding orphaned
    keep = {o.name for o in model.outputs} | {i.name for i in model.inputs}
    values = [v for v in new_values.values()
              if v.outputs or getattr(v, "inputs", None) or v.name in keep]
    inputs = [new_values[v.name] for v in model.inputs]
    outputs = [new_values[v.name] for v in model.outputs]
    return DynamicQModel(new_nodes, values, inputs, outputs, bit_width,
                         granularity, dev)
