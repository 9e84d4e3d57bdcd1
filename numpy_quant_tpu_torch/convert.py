"""Carry a quantized model's constants across from the JAX package.

``load_jax_params`` installs, in the port's QModel, the integer payloads
and quantization parameters of the JAX package's QModel for the same
graph, given as plain numpy (the port never imports JAX); in a float
Model after ``quantize_weights``, the weight-only constants alone (packed
with a per-channel or grouped scale, or unpacked), with no
``quant_params``:

    state = {
        "constants": {value name: {"payload": int array, "scale": ...,
                                   "zero_point": ... or None,
                                   "bit_width": int}},
        "quant_params": {value name: (scale, zero_point or None)},
    }

Payloads are integer weights (1-16 bits) or 4x-width biases (32 bits at 8;
up to 64 bits in a model above 8 bits, whose payloads, like those of the JAX
package's x64 mode, are int64 containers); the 32-bit biases include the
GPT and LLaMA causal LMs' additive mask constants, which ``quantize`` stores
as 32-bit biases clipped at -2^31 on the scores' scale, so the dequantized
mask value (the fused kernels' ``causal_mask_val``) carries across too. The
T5 graphs' score-bias constants are 32-bit biases on the scores' scale as
well: the encoder's relative position bias (``encoder.rel_bias``) and the
decoder's combined bias + finfo.min constant (``decoder.rel_bias_masked``,
clipped at -2^31), which ride into ``FusedAttentionHS`` as its 4th input.
The LLaMA graph's RMSNorm weights and RoPE tables are 8-bit constants like
any weight.

A packed weight (the JAX package's ``PackedQTensor``, after its
``pack_weights()``) is given as ``{"layout": "splitk", "bitplanes" or
"splitk_stacked", "k": K, "n": N, "bit_width": b, "scale": ...,
"payload": the packed array, "colsum": int32 [1, N]}`` and is installed
packed, byte for byte: a tensor-parallel model's stacked row groups
[S, KR_local, N] with their global colsum too. A model whose Q/K/V
products JAX merged (``merge_parallel_matmuls``) takes its merged
``<node>/merged_w`` constants once the port's graph is merged the same
way.

The two packages then compute the same function on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import Constant
from .model import Model, QModel, QuantizationParams
from .tensor import PackedQTensor, QTensor


def load_jax_params(qmodel: Model, state: dict) -> int:
    """Install ``state`` into ``qmodel`` (a QModel, or a weight-only float
    Model) on its device; returns the number of constants replaced. Every
    quantized constant of the port's graph must be present."""
    consts = state["constants"]
    qparams = state.get("quant_params") or {}
    if qparams and not isinstance(qmodel, QModel):
        raise ValueError("quant_params given for a float (weight-only) Model")
    # a QModel's integer container; a weight-only float model's is int32
    container = qmodel.container if isinstance(qmodel, QModel) \
        else torch.int32
    replaced = 0
    for value in qmodel.values:
        if not isinstance(value, Constant) \
                or not isinstance(value.data, (QTensor, PackedQTensor)):
            continue
        if value.name not in consts:
            raise KeyError(f"no payload for constant {value.name!r}")
        c = consts[value.name]
        payload = np.asarray(c["payload"])
        if "layout" in c:
            value.data = _packed(c, payload, value, qmodel.device)
            replaced += 1
            continue
        if payload.shape != tuple(value.data.shape):
            raise ValueError(f"{value.name}: payload shape {payload.shape} "
                             f"!= {tuple(value.data.shape)}")
        zp = c["zero_point"]
        value.data = QTensor(
            torch.tensor(payload, dtype=container).to(qmodel.device),
            int(c["bit_width"]), np.asarray(c["scale"], np.float32),
            None if zp is None else np.int64(zp))
        replaced += 1
    for name, (scale, zp) in qparams.items():
        qmodel.quant_params[name] = QuantizationParams(
            np.asarray(scale, np.float32), None if zp is None else np.int64(zp))
    if isinstance(qmodel, QModel):
        qmodel.invalidate_params()
    return replaced


def _packed(c: dict, payload: np.ndarray, value: Constant, device):
    """A packed weight entry of ``state`` as a PackedQTensor on ``device``."""
    k, n = int(c["k"]), int(c["n"])
    if (k, n) != tuple(value.data.shape):
        raise ValueError(f"{value.name}: packed shape {(k, n)} != "
                         f"{tuple(value.data.shape)}")
    dtype = np.int8 if c["layout"] in ("splitk", "splitk_stacked") \
        and int(c["bit_width"]) == 8 else np.uint8
    colsum = np.array(c["colsum"], np.int32).reshape(1, n)
    return PackedQTensor(torch.from_numpy(payload.astype(dtype)).to(device),
                         torch.from_numpy(colsum).to(device), k, n,
                         int(c["bit_width"]),
                         np.asarray(c["scale"], np.float32),
                         layout=c["layout"])
