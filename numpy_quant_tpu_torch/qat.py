"""Quantization-aware training (QAT): end-to-end weight fine-tuning under
fake quantization.

Port of ``numpy_quant_tpu/qat.py``. The PTQ passes repair each layer in
isolation; QAT differentiates through the whole quantized forward (torch
autograd over the float executor's walk, straight-through estimators at
the rounding points) and lets every weight move to make up for every
other layer's rounding error.

Simulation model (faithful to the integer executor, QModel):

- float graph inputs  -> fake-quant at their calibrated asymmetric params
  (QModel._wrap_input quantizes on entry),
- quantized constants -> fake-quant at the exact (scale, zero_point,
  bit_width) the PTQ pass assigned (per-channel scales and the
  4x-bit-width bias scales s_x*s_w included),
- float inputs of quantized ops (MatMul/Gemm/Conv) -> fake-quant at the
  value's calibrated params (QModel._node_inputs),
- outputs of requantized ops (Gemm, integer Conv) -> fake-quant with
  requantize's rint-then-clip rounding (QModel._post_node).

MatMul outputs stay exact accumulators in the integer executor, so they
get no output fake-quant here. Everything else runs the float executor's
ops on dequantized values. ``fake_quant_forward`` exposes this simulated
forward.

Straight-through estimator: forward dequant(quant(x)), gradient the
identity inside the representable range and zero outside.

Deployment contract: the quantization params are frozen from the first
calibration (the scales trained against are the scales served), and the
float model passed in is left untouched: the tuned weights live only in
the returned QModel. Compose as ``model.qat_quantize(...)`` ->
``optimize()`` -> ``pack_weights()``. Training runs on the model's device
and reaches no hand kernel (the fake quant is plain torch); the deployed
QModel runs the quantize/dequantize, attention and packed-matmul kernels
like any other.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .graph import Constant, Variable
from .intops import qrange
from .model import Model, QModel
from .tensor import FTensor, ITensor, QTensor


def _fq(x: torch.Tensor, scale, zero_point, bit_width: int,
        rint_first: bool = False) -> torch.Tensor:
    """Fake-quantize ``x``: forward dequant(quant(x)), straight-through
    gradient (identity inside the representable range, zero outside).

    ``rint_first`` selects requantize's rint-then-clip rounding through the
    reciprocal of the scale instead of quantize's clip-then-rint through
    the IEEE quotient; the two differ only near the saturation bounds. The
    scale is a float32 device tensor (scalar or per channel), so ``x / s``
    divides exactly on the card too. A scale of 0 (a constant-valued
    tensor) passes ``x`` through."""
    lo, hi = qrange(bit_width)
    s = torch.as_tensor(np.asarray(scale, np.float32), device=x.device)
    degenerate = s == 0
    one = torch.ones((), dtype=torch.float32, device=x.device)
    s = torch.where(degenerate, one, s)
    zp = torch.zeros((), dtype=torch.float32, device=x.device) \
        if zero_point is None else torch.as_tensor(
            np.asarray(zero_point, np.float32), device=x.device)
    if rint_first:
        q = torch.clamp(torch.round(x * (one / s) + zp), lo, hi)
    else:
        q = torch.round(torch.clamp(x / s + zp, lo, hi))
    dq = (q - zp) * s
    # the representable float range: the gradient passes only where x
    # would not saturate
    lo_val = (torch.full((), lo, device=x.device) - zp) * s
    hi_val = (torch.full((), hi, device=x.device) - zp) * s
    passthrough = torch.where((x >= lo_val) & (x <= hi_val), x, x.detach())
    y = passthrough + (dq - passthrough).detach()
    return torch.where(degenerate, x, y)


class _FakeQuantModel(Model):
    """The float executor with fake quantization at the integer executor's
    quantize points. It borrows the float model's graph; ``params``
    ({constant name: tensor}) stand in for those constants' payloads in
    the walk (the trainable tensors). ``qref=None`` turns fake
    quantization off: the plain float walk under autograd, which the
    fixture trainers (``train.py``) train through."""

    def __init__(self, float_model: Model, qref: QModel | None):
        super().__init__(float_model.nodes, float_model.values,
                         float_model.inputs, float_model.outputs,
                         float_model.device)
        self.params: dict[str, torch.Tensor] = {}
        # name -> (scale, zero_point, bit_width) of every float constant
        # the PTQ pass quantized (weights, biases, quantized scalars)
        self._const_fq: dict[str, tuple] = {}
        self.bit_width = None if qref is None else qref.bit_width
        self.quant_params = {} if qref is None else qref.quant_params
        self.quantized_ops = () if qref is None else qref.quantized_ops
        self.requantized_ops = () if qref is None else qref.requantized_ops
        if qref is None:
            return
        qvals = {v.name: v for v in qref.values}
        for value in float_model.values:
            if not isinstance(value, Constant) \
                    or not isinstance(value.data, FTensor):
                continue
            qv = qvals.get(value.name)
            if isinstance(qv, Constant) and isinstance(qv.data, QTensor):
                qt = qv.data
                self._const_fq[value.name] = (qt.scale, qt.zero_point,
                                              qt.bit_width)

    def _wrap_input(self, array, variable: Variable):
        t = super()._wrap_input(array, variable)
        if isinstance(t, FTensor) and self.bit_width is not None:
            qp = self.quant_params[variable.name]
            return FTensor(_fq(t.data, qp.scale, qp.zero_point,
                               self.bit_width))
        return t

    def _wrap_constant(self, value: Constant):
        t = super()._wrap_constant(value)
        fq = self._const_fq.get(value.name)
        if fq is not None and isinstance(t, FTensor):
            scale, zp, bw = fq
            host = getattr(t, "host", None)
            t = FTensor(_fq(self.params.get(value.name, t.data), scale, zp,
                            bw))
            if host is not None:
                t.host = host  # shape-domain reads (host scalars)
        return t

    def _node_inputs(self, node, data, timings=None):
        ins = super()._node_inputs(node, data, timings)
        if node.op not in self.quantized_ops:
            return ins
        out = []
        for v, t in zip(node.inputs, ins):
            # constants were fake-quantized at wrap time (at their own,
            # possibly 4x-bit-width or per-channel params); live float
            # values quantize on the fly
            if t is not None and isinstance(t, FTensor) \
                    and not isinstance(v, Constant):
                qp = self.quant_params[v.name]
                t = FTensor(_fq(t.data, qp.scale, qp.zero_point,
                                self.bit_width))
            out.append(t)
        return out

    def _post_node(self, node, outputs):
        if node.op in self.requantized_ops:
            qp = self.quant_params[node.outputs[0].name]
            outputs = [FTensor(_fq(t.data, qp.scale, qp.zero_point,
                                   self.bit_width, rint_first=True))
                       for t in outputs]
        return outputs

    def walk(self, arrays: list) -> list[torch.Tensor]:
        """The simulated forward over ``arrays`` (int64 host arrays bound
        as static shape-domain inputs): the output tensors, float32."""
        input_tensors = {v.name: self._wrap_input(a, v)
                         for a, v in zip(arrays, self.inputs)}
        data = self._forward(input_tensors)
        return [self._finalize_output(data[o.name]) for o in self.outputs]


def fake_quant_forward(model: Model, qref: QModel,
                       inputs: list[np.ndarray]) -> list[np.ndarray]:
    """Run the fake-quant simulation of ``qref`` on ``inputs`` (a debug
    and test hook: its outputs track ``qref(inputs)`` up to f32-against-
    integer accumulation rounding)."""
    fqm = _FakeQuantModel(model, qref)
    with torch.no_grad():
        outs = fqm.walk([np.asarray(a) for a in inputs])
    return [o.cpu().numpy() for o in outs]


def _ce_loss(labels: torch.Tensor):
    """Mean softmax cross-entropy of ``outs[0]`` against integer labels,
    optax's form: logsumexp(logits) - logits[label]."""
    def loss_fn(outs):
        logits = outs[0]
        picked = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(torch.logsumexp(logits, dim=-1) - picked)
    return loss_fn


def _distill_loss(teacher: list):
    """Normalized MSE against the float model's own outputs, summed over
    the outputs."""
    eps = torch.full((), 1e-8, dtype=torch.float32,
                     device=teacher[0].device)

    def loss_fn(outs):
        total = torch.zeros((), dtype=torch.float32, device=eps.device)
        for o, t in zip(outs, teacher):
            total = total + torch.mean((o - t) ** 2) / (torch.mean(t * t)
                                                        + eps)
        return total
    return loss_fn


def qat_quantize(model: Model, inputs: list[np.ndarray], *,
                 steps: int = 200, lr: float = 1e-4,
                 labels: np.ndarray = None,
                 loss_fn: Callable = None,
                 train_filter: Callable[[str], bool] = None,
                 calibration_mode: str = "auto",
                 verbose: bool = False,
                 **quantize_kw) -> QModel:
    """Fine-tune ``model``'s weights under fake quantization, then quantize
    with the same frozen calibration params. Returns the QModel of the
    tuned weights (with a float32 ``qat_loss_history``); the float model
    is left untouched.

    Loss, in priority order: ``loss_fn(outputs)`` -> a scalar tensor over
    the output tensors; else the cross-entropy of ``outputs[0]`` against
    integer ``labels``; else self-distillation, the normalized MSE against
    the float model's own outputs on ``inputs`` (the calibration batch is
    the training set, the float model the teacher).

    ``train_filter(name) -> bool`` restricts which quantized constants
    train (default: all of them). ``quantize_kw`` goes to
    :meth:`Model.quantize` (bit_width, weight_bit_width,
    per_channel_weights, quantize_conv, percentile, ...). Adam with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8) at ``lr``; the loss is read
    before each update and the iterate with the lowest loss is deployed."""
    arrays = [np.asarray(a) for a in inputs]
    stats = model.calibration_stats(
        arrays, mode=calibration_mode,
        percentile=quantize_kw.get("percentile"))
    qref = model.quantize(stats=stats, **quantize_kw)
    fqm = _FakeQuantModel(model, qref)
    dev = model.device

    if loss_fn is None and labels is None:
        teacher = [o.clone() for o in model(arrays, as_numpy=False)]
        loss_fn = _distill_loss(teacher)
    elif loss_fn is None:
        loss_fn = _ce_loss(torch.from_numpy(
            np.asarray(labels).astype(np.int64)).to(dev))

    # trainable: the fake-quantized float constants. Zero-scale constants
    # (all-equal payloads, e.g. fresh LayerNorm biases) deploy at their
    # frozen zero scale whatever training does, so they stay frozen.
    values = {v.name: v for v in model.values if isinstance(v, Constant)}
    names = [n for n, (scale, _, _) in fqm._const_fq.items()
             if np.all(np.asarray(scale) != 0)
             and (train_filter is None or train_filter(n))]
    trainable = {n: values[n].data.data.detach().to(torch.float32).clone()
                 .requires_grad_(True) for n in names}
    fqm.params = trainable
    # float inputs on the device once; int64 inputs stay host arrays,
    # bound as static shape-domain constants
    feeds = [a if a.dtype == np.int64
             else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in arrays]

    opt = torch.optim.Adam(list(trainable.values()), lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    history = []
    best_loss, best = np.inf, None
    for i in range(int(steps)):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(fqm.walk(feeds))
        loss.backward()
        value = float(loss.detach())  # the loss at the pre-update params
        if value < best_loss:
            best_loss = value
            best = {n: t.detach().clone() for n, t in trainable.items()}
        history.append(value)
        opt.step()
        if verbose and (i % 50 == 0 or i == steps - 1):
            print(f"qat step {i}: loss {value:.6g}")
    if best is None:
        best = {n: t.detach() for n, t in trainable.items()}

    # re-quantize the tuned weights with the frozen stats; the float
    # model's own payloads are restored whatever happens
    saved = {}
    try:
        for name, tensor in best.items():
            saved[name] = values[name].data
            values[name].data = FTensor(tensor)
        qmodel = model.quantize(stats=stats, **quantize_kw)
    finally:
        for name, data in saved.items():
            values[name].data = data
    qmodel.qat_loss_history = np.asarray(history, np.float32)
    return qmodel
