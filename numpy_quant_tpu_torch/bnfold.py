"""BatchNormalization folding: fuse inference-mode BN into the
preceding Conv/Gemm's weights and bias.

With saved statistics, BN is the per-channel affine

    y = k * x + shift,   k = gamma / sqrt(var + eps),
                         shift = beta - mean * k

and a Conv/Gemm followed by BN is exactly another Conv/Gemm:

    W' = W * k (per OUTPUT channel),  b' = b * k + shift

Folding before calibration is the standard PTQ recipe for BN nets
(ResNet-style exports): the integer path then sees one conv per block
instead of conv + float affine, and the calibrated ranges are those of
the arithmetic actually served.

Port of ``numpy_quant_tpu/bnfold.py``: the weight math is the same numpy
float32 code in the same order, on host copies of the device constants,
so the folded weights and biases equal the JAX package's bit for bit.
Run on the FLOAT model before ``quantize`` (Model.fold_batchnorm).
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import Constant
from .tensor import FTensor


def _host(value) -> np.ndarray:
    return value.data.data.to("cpu", torch.float32).numpy()


def _device_const(arr: np.ndarray, device) -> FTensor:
    """A folded float32 array as a constant on ``device``, keeping the
    host copy small constants carry (graph.wrap_array)."""
    t = FTensor(torch.from_numpy(np.array(arr, np.float32)).to(device))
    if arr.size <= 64 or arr.ndim == 1:
        t.host = np.array(arr, np.float32)
    return t


def _const1d(value):
    if isinstance(value, Constant) and isinstance(value.data, FTensor):
        arr = _host(value)
        if arr.ndim == 1:
            return arr
    return None


def _fold_axis(node, W):
    """Output-channel axis of the stored weight, or None if the node's
    output channels cannot be scaled by mutating the weight."""
    if node.op == "Conv":
        # [Cout, Cin/g, ...]: axis 0 is the output channel for any group
        return 0 if W.ndim >= 3 else None
    if node.op == "Gemm" and W.ndim == 2:
        return 0 if node.attrs.get("transB") else 1
    return None


def fold_batchnorm(model) -> int:
    """Fold every BatchNormalization whose input is the single-consumer
    output of a constant-weight Conv/Gemm. Mutates the float model in
    place (weights/bias rewritten, BN nodes removed); quantize
    afterwards. Returns the number of BN nodes folded."""
    out_names = {o.name for o in model.outputs}
    folded = 0
    for bn in [n for n in model.nodes if n.op == "BatchNormalization"]:
        if int(bn.attrs.get("training_mode", 0)) or len(bn.outputs) != 1:
            continue
        params = [_const1d(v) for v in bn.inputs[1:5]]
        if len(bn.inputs) < 5 or any(p is None for p in params):
            continue
        gamma, beta, mean, var = params
        x_val = bn.inputs[0]
        prods = list(getattr(x_val, "inputs", []))
        if len(prods) != 1 or x_val.name in out_names:
            continue
        prod = prods[0]
        if prod.outputs[0] is not x_val:
            continue
        if [n for n in model.nodes if x_val in n.inputs] != [bn]:
            continue  # another consumer reads the pre-BN value
        w_val = prod.inputs[1] if len(prod.inputs) > 1 else None
        if not (isinstance(w_val, Constant)
                and isinstance(w_val.data, FTensor)):
            continue
        W = _host(w_val)
        ax = _fold_axis(prod, W)
        if ax is None or W.shape[ax] != gamma.shape[0]:
            continue
        if len(w_val.outputs) != 1:
            continue  # shared weight: scaling would change other users

        eps = np.float32(bn.attrs.get("epsilon", 1e-5))
        k = (gamma / np.sqrt(var + eps)).astype(np.float32)
        shift = (beta - mean * k).astype(np.float32)

        ksh = [1] * W.ndim
        ksh[ax] = -1
        w_val.data = _device_const((W * k.reshape(ksh)).astype(np.float32),
                                   model.device)

        # bias: b' = b * k + shift. Gemm applies beta to the bias, so
        # the shift contribution divides by beta (exact); beta == 0
        # means "no bias term" -- materialize one and set beta = 1.
        beta_attr = float(prod.attrs.get("beta", 1.0)) \
            if prod.op == "Gemm" else 1.0
        b_val = prod.inputs[2] if len(prod.inputs) > 2 else None
        b_arr = _const1d(b_val) if b_val is not None else None
        if b_val is not None and b_arr is None:
            continue  # non-constant / non-vector bias: leave BN in place
        if b_val is not None and len(b_val.outputs) != 1:
            continue  # shared bias
        if b_arr is not None and beta_attr != 0.0:
            new_b = b_arr * k + shift / np.float32(beta_attr)
            b_val.data = _device_const(new_b.astype(np.float32),
                                       model.device)
        else:
            if prod.op == "Gemm":
                prod.attrs["beta"] = 1.0
            new_bias = Constant(f"{prod.name}/folded_bias", outputs=[prod],
                                data=_device_const(shift, model.device))
            model.values.append(new_bias)
            if b_val is not None:  # beta == 0: replace the dead bias
                prod.inputs[2] = new_bias
                b_val.outputs = [n for n in b_val.outputs if n is not prod]
            else:
                prod.inputs.append(new_bias)

        # rewire: prod now writes BN's output value; BN + the
        # intermediate value + its exclusive BN params leave the graph
        y_val = bn.outputs[0]
        prod.outputs[0] = y_val
        y_val.inputs = [prod]
        model.nodes.remove(bn)
        if x_val in model.values:
            model.values.remove(x_val)
        for pv in bn.inputs[1:5]:
            pv.outputs = [n for n in pv.outputs if n is not bn]
            if not pv.outputs and pv.name not in out_names \
                    and pv in model.values:
                model.values.remove(pv)
        folded += 1

    if folded:
        model.invalidate_params()
    return folded
