"""Empirical bias correction (the empirical variant of AIMET's bias
correction, arXiv:2201.08442 section IV); port of
``numpy_quant_tpu/bias_correction.py``.

Quantization shifts each weight layer's expected output, E[y_q] !=
E[y_f]; a per-output-channel shift folds exactly into the layer's
additive bias. The mean output error of each layer is measured on the
device: the float model's outputs of the layers are kept on the device
from one walk, and the quantized model's walk reduces its error against
them as each output is made (float64 means, as the JAX package's).
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import Constant
from .passes.weights import float_array, set_float, shift_q_bias
from .tensor import FTensor, PackedQTensor, QTensor
from .utils.parity import record_values


def _targets(qmodel) -> list:
    """[(output value name, bias Constant, reduce over NCHW)] of every
    quantized weight op whose bias can absorb a correction: the Gemm /
    integer Conv bias input, or the rank-1 constant Add consuming a
    MatMul's output (the exporter's linear form), measured at the Add's
    output (the additive bias commutes)."""
    out = []
    for node in qmodel.nodes:
        if node.op not in ("MatMul", "Gemm", "Conv") or len(node.inputs) < 2:
            continue
        w = node.inputs[1]
        if not isinstance(w, Constant) \
                or not isinstance(w.data, (QTensor, PackedQTensor)):
            continue  # activation x activation product: no weight
        if node.op in ("Gemm", "Conv"):
            if len(node.inputs) < 3 \
                    or not isinstance(node.inputs[2], Constant) \
                    or not isinstance(node.inputs[2].data, QTensor):
                continue
            out.append((node.outputs[0].name, node.inputs[2],
                        node.op == "Conv"))
            continue
        out_val = node.outputs[0]
        cons = [n for n in qmodel.nodes if out_val in n.inputs]
        if len(cons) != 1 or cons[0].op != "Add":
            continue
        add = cons[0]
        other = add.inputs[1] if add.inputs[0] is out_val else add.inputs[0]
        if not isinstance(other, Constant) \
                or not isinstance(other.data, (FTensor, QTensor)) \
                or other.data.data.ndim != 1:
            continue
        out.append((add.outputs[0].name, other, False))
    return out


def correct_biases_qmodel(qmodel, float_model, inputs: list,
                          passes: int = 1) -> int:
    """For every quantized weight op, SUBTRACT the mean output error over
    the calibration batch from its bias: a quantized (Gemm / integer Conv
    / quantized Add) bias absorbs ``rint(corr / bias_scale)`` in its
    integer domain (``shift_q_bias``), a float Add bias ``corr`` itself.
    ``float_model``: the unquantized source model (the oracle);
    ``passes > 1`` re-measures after correcting, so later layers see
    corrected earlier ones. Returns the number of corrected biases,
    summed over passes."""
    corrected = 0
    for _ in range(int(passes)):
        targets = _targets(qmodel)
        names = {name for name, _, _ in targets}
        conv = {name for name, _, is_conv in targets if is_conv}
        f_acts = record_values(float_model, inputs, names)

        def mean_error(name, q):
            f = f_acts.pop(name, None)
            if f is None or f.shape != q.shape:
                return None
            err = q.to(torch.float64) - f.to(torch.float64)
            if name in conv:
                return err.mean(dim=(0, 2, 3)) if err.ndim == 4 else None
            return err.reshape(-1, err.shape[-1]).mean(dim=0)

        corrs = record_values(qmodel, inputs, names, mean_error)
        for name, bias, _ in targets:
            corr = corrs.get(name)
            if corr is None:
                continue
            corr = corr.cpu().numpy()
            if isinstance(bias.data, FTensor):
                bias_arr = float_array(bias)
                if corr.shape != bias_arr.shape:
                    continue
                set_float(bias, bias_arr - corr.astype(np.float32))
                corrected += 1
            else:
                corrected += shift_q_bias(bias, corr)
        qmodel.invalidate_params()
    return corrected
