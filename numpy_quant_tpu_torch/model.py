"""Model / QModel: ONNX graph import, execution, calibration and PTQ
(port of ``numpy_quant_tpu/model.py``).

The forward is an eager walk over the graph's nodes on the model's
device; JAX's one-jitted-program lowering has no counterpart here.
``QModel`` quantizes float inputs of the integer ops on the fly,
dequantizes quantized inputs of every other op, requantizes Gemm/Conv
outputs and dequantizes quantized graph outputs -- the reference
executor's boundary rules, unchanged.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import config
from . import onnx as onnx_lib
from .graph import (Constant, Node, Value, Variable, import_onnx,
                    only_rhs_of)
from .ops.registry import onnx_operator_implementation
from .passes.toolkit import PASSTHROUGH_OPS
from .quantization import (per_channel_scales, quant_parameters, quantize,
                           weight_only_scales)
from .tensor import (
    FTensor,
    ITensor,
    PackedQTensor,
    QTensor,
    Tensor,
    pack_qtensor,
    quantize_tensor,
)


class QuantizationParams:
    """(scale, zero_point) record."""

    def __init__(self, scale, zero_point):
        self.scale = scale
        self.zero_point = zero_point

    def __repr__(self):
        return f"QuantizationParams(scale={self.scale}, zero_point={self.zero_point})"


class Model:
    def __init__(self, nodes: list[Node], values: list[Value],
                 inputs: List[Variable], outputs: List[Value],
                 device: torch.device):
        self.nodes = nodes
        self.values = values
        self.inputs = inputs
        self.outputs = outputs
        self.device = torch.device(device)

    def __repr__(self):
        return (f"{type(self).__name__}(nodes={len(self.nodes)}, "
                f"values={len(self.values)}, device={self.device})")

    @classmethod
    def from_onnx(cls, onnx_model: onnx_lib.ModelProto, device=None) -> "Model":
        """Import an ONNX graph; its float initializers move to
        ``device`` (CUDA unless the caller passes another)."""
        dev = config.resolve_device(device)
        nodes, values, inputs, outputs = import_onnx(onnx_model, dev)
        return cls(nodes, values, inputs, outputs, dev)

    # ------------------------------------------------------------------
    # Input/constant wrapping (overridden by QModel)
    # ------------------------------------------------------------------

    def _device_tensor(self, array) -> torch.Tensor:
        if isinstance(array, torch.Tensor):
            return array.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _wrap_input(self, array, variable: Variable) -> Tensor:
        if isinstance(array, np.ndarray) and array.dtype == np.int64:
            return ITensor(array)
        t = self._device_tensor(array)
        if t.dtype == torch.float32:
            return FTensor(t)
        raise ValueError(f"Array dtype {t.dtype} not supported")

    def _wrap_constant(self, value: Constant) -> Tensor:
        if isinstance(value.data, FTensor):
            # re-wrapped per forward: casts to the current float dtype
            return FTensor(value.data.data)
        return value.data

    # ------------------------------------------------------------------
    # Node walk
    # ------------------------------------------------------------------

    def _node_inputs(self, node: Node, data: dict[str, Tensor]) -> list[Tensor]:
        return [None if v is None else data[v.name] for v in node.inputs]

    def _post_node(self, node: Node, outputs: list[Tensor]) -> list[Tensor]:
        return outputs

    def _forward(self, input_tensors: dict[str, Tensor],
                 record: bool = False) -> dict[str, Tensor]:
        data: dict[str, Tensor] = {}
        for value in self.values:
            if isinstance(value, Constant):
                data[value.name] = self._wrap_constant(value)
        data.update(input_tensors)
        for node in self.nodes:
            ins = self._node_inputs(node, data)
            outs = onnx_operator_implementation(node.op, ins, node.attrs,
                                                device=self.device)
            outs = self._post_node(node, outs)
            for o, tensor in zip(node.outputs, outs):
                data[o.name] = tensor
                if record:
                    o.data = tensor
        if record:
            for variable in self.inputs:
                variable.data = input_tensors.get(variable.name, variable.data)
        return data

    def _finalize_output(self, tensor: Tensor):
        data = tensor.data
        if isinstance(data, torch.Tensor) and data.dtype == torch.bfloat16:
            return data.to(torch.float32)
        return data

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def __call__(self, inputs: list, record: bool = False,
                 as_numpy: bool = True):
        """Run the model on numpy arrays or tensors. ``record=True``
        also stores every value's tensor in ``value.data``.
        ``as_numpy=False`` returns the outputs as device tensors."""
        input_tensors = {v.name: self._wrap_input(a, v)
                         for a, v in zip(inputs, self.inputs)}
        data = self._forward(input_tensors, record=record)
        outs = [self._finalize_output(data[o.name]) for o in self.outputs]
        if as_numpy:
            return [o.cpu().numpy() if isinstance(o, torch.Tensor)
                    else np.asarray(o) for o in outs]
        return outs

    def _infer_shapes(self):
        """Static shapes of every graph value, from one forward over
        zeros shaped by the inputs' ValueInfo hints (symbolic dims
        become 2). Returns ``{value_name: shape tuple}``, or None when a
        hint is missing or an input is not float."""
        hints = []
        for v in self.inputs:
            h = getattr(v, "shape_hint", None)
            if h is None or getattr(v, "dtype_hint", None) != 1:  # FLOAT
                return None
            hints.append(tuple(2 if not d else int(d) for d in h))
        input_tensors = {
            v.name: self._wrap_input(torch.zeros(h, device=self.device), v)
            for v, h in zip(self.inputs, hints)}
        with torch.inference_mode():
            data = self._forward(input_tensors)
        return {name: tuple(int(s) for s in t.data.shape)
                for name, t in data.items()}

    # ------------------------------------------------------------------
    # Calibration + PTQ pass
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def calibration_stats(self, inputs: list) -> dict:
        """Global min/max per value name (constants included), from one
        eager forward."""
        input_tensors = {v.name: self._wrap_input(a, v)
                         for a, v in zip(inputs, self.inputs)}
        data = self._forward(input_tensors)
        stats = {}
        for name, tensor in data.items():
            if isinstance(tensor, ITensor):
                stats[name] = (np.float32(tensor.data.min()),
                               np.float32(tensor.data.max()))
            else:
                d = tensor.data.to(torch.float32)
                stats[name] = (np.float32(d.min().item()),
                               np.float32(d.max().item()))
        return stats

    @torch.inference_mode()
    def quantize(self, calibration_inputs: list = None, bit_width: int = 8,
                 stats: dict = None, quantize_conv: bool = False,
                 per_channel_weights: bool = False,
                 weight_bit_width=None) -> "QModel":
        """Post-training quantization with the reference's per-node
        strategy: asymmetric graph inputs and MatMul/Gemm/Conv/Add
        outputs, symmetric per-tensor constants, Gemm/Conv/Add biases at
        4x bit width on the accumulator scale.

        ``stats``: a precomputed {value name: (min, max)} dict (from
        calibration_stats); else ``calibration_inputs`` are calibrated.
        ``quantize_conv``: run Conv on the integer path (im2col + int8
        product).
        ``per_channel_weights``: symmetric per-output-channel scales for
        2-D MatMul/Gemm weights.
        ``weight_bit_width``: quantize MatMul/Gemm weights (constants
        consumed only as their rhs) at another width than activations
        (W4A8 and the like; pack_weights() then stores exactly that many
        bits); a dict ``{weight name: bits}`` sets per-weight widths,
        unlisted weights keep ``bit_width``."""
        wbw_map = weight_bit_width if isinstance(weight_bit_width, dict) \
            else None
        wbw = weight_bit_width if isinstance(weight_bit_width, int) \
            else bit_width
        widths = [bit_width, wbw, *(wbw_map or {}).values()]
        if max(widths) > 8:
            raise NotImplementedError(
                f"bit widths above 8 are not ported (got {max(widths)})")
        if stats is None:
            stats = self.calibration_stats(calibration_inputs)
        node_dict = {node.name: node for node in self.nodes}
        value_dict = {value.name: value for value in self.values}

        def qparams_for(name: str, asymmetric: bool,
                        bits: int = None) -> QuantizationParams:
            mn, mx = stats[name]
            scale, zero_point = quant_parameters(
                mn, mx, bit_width=bit_width if bits is None else bits,
                asymmetric=asymmetric)
            return QuantizationParams(scale, zero_point)

        def weight_channel_axis(value):
            """Output-channel axis if this constant is only ever the
            weight (input 1) of MatMul/Gemm nodes, else None."""
            if not value.outputs:
                return None
            axes = set()
            for n in value.outputs:
                if len(n.inputs) < 2 or n.inputs[1] is not value:
                    return None
                if n.op == "MatMul":
                    axes.add(1)  # [K, N]: channels last
                elif n.op == "Gemm":
                    axes.add(0 if n.attrs.get("transB") else 1)
                else:
                    return None
            return axes.pop() if len(axes) == 1 else None

        qnodes_dict: dict[str, Node] = {}
        qvalues_dict: dict[str, Value] = {}
        qparams_per_value: dict[str, QuantizationParams] = {}

        # graph inputs: asymmetric
        for value in self.inputs:
            qvar = Variable(value.name, [], [], None)
            qvar.shape_hint = getattr(value, "shape_hint", None)
            qvar.dtype_hint = getattr(value, "dtype_hint", None)
            qvalues_dict[value.name] = qvar
            qparams_per_value[value.name] = qparams_for(
                value.name, isinstance(value, Variable))

        # constants: symmetric, per-tensor or (2-D weights) per-channel
        for value in self.values:
            if isinstance(value, Constant):
                if isinstance(value.data, ITensor):
                    qvalues_dict[value.name] = Constant(value.name, [],
                                                        value.data.copy())
                    continue
                cbw = bit_width
                if only_rhs_of(value, ("MatMul", "Gemm")):
                    cbw = wbw if wbw_map is None \
                        else wbw_map.get(value.name, bit_width)
                ch_axis = weight_channel_axis(value) if per_channel_weights \
                    else None
                if ch_axis is not None and value.data.data.ndim == 2:
                    qp = QuantizationParams(per_channel_scales(
                        value.data.data.cpu().numpy(), cbw, ch_axis), None)
                else:
                    qp = qparams_for(value.name, asymmetric=False, bits=cbw)
                qvalues_dict[value.name] = Constant(
                    value.name, [],
                    quantize_tensor(value.data, cbw, qp.scale,
                                    qp.zero_point))
                qparams_per_value[value.name] = qp

        def quantize_bias(bias, bias_scale):
            qparams_per_value[bias.name] = QuantizationParams(bias_scale, None)
            qbias = quantize_tensor(value_dict[bias.name].data,
                                    4 * bit_width, bias_scale, None)
            qvalues_dict[bias.name] = Constant(bias.name, [], qbias)

        # per-node strategy
        for node in self.nodes:
            def register_out_asym():
                out_val = node.outputs[0]
                qvalues_dict[out_val.name] = Variable(out_val.name, [], [], None)
                qparams_per_value[out_val.name] = qparams_for(out_val.name, True)
                qnodes_dict[node.name] = Node(node.name, node.op, node.attrs, [], [])

            if node.op == "MatMul":
                register_out_asym()
            elif node.op == "Gemm":
                for input_value in node.inputs[:2]:
                    if isinstance(input_value, Variable):
                        qvalues_dict[input_value.name] = Variable(
                            input_value.name, [], [], None)
                        qparams_per_value[input_value.name] = qparams_for(
                            input_value.name, True)
                if len(node.inputs) > 2 and node.inputs[2] is not None:
                    bias_scale = qparams_per_value[node.inputs[0].name].scale \
                        * qparams_per_value[node.inputs[1].name].scale
                    # alpha folds into the accumulator scale at run time,
                    # so the bias quantizes at alpha*s1*s2/beta
                    alpha = np.float32(node.attrs.get("alpha", 1.0))
                    beta = np.float32(node.attrs.get("beta", 1.0))
                    if float(beta) != 0.0 and (float(alpha) != 1.0
                                               or float(beta) != 1.0):
                        bias_scale = bias_scale * alpha / beta
                    if getattr(bias_scale, "ndim", 0) > 0:
                        # per-channel weight: one scale per bias entry
                        bias_scale = np.asarray(bias_scale,
                                                np.float32).reshape(-1)
                    quantize_bias(node.inputs[2], bias_scale)
                register_out_asym()
            elif node.op == "Conv" and quantize_conv:
                if len(node.inputs) > 2 and node.inputs[2] is not None:
                    bias_scale = qparams_per_value[node.inputs[0].name].scale \
                        * qparams_per_value[node.inputs[1].name].scale
                    quantize_bias(node.inputs[2], bias_scale)
                register_out_asym()
            elif node.op == "Add" and (isinstance(node.inputs[0], Constant)
                                       or isinstance(node.inputs[1], Constant)):
                bias_ind = 0 if isinstance(node.inputs[0], Constant) else 1
                x_name = node.inputs[1 - bias_ind].name
                quantize_bias(node.inputs[bias_ind],
                              qparams_per_value[x_name].scale)
                register_out_asym()
            elif node.op in ("Identity", "Relu"):
                out_val = node.outputs[0]
                qvalues_dict[out_val.name] = Variable(out_val.name, [], [], None)
                qparams_per_value[out_val.name] = \
                    qparams_per_value[node.inputs[0].name]
                qnodes_dict[node.name] = Node(node.name, node.op, node.attrs, [], [])
            else:
                for out_val in node.outputs:
                    qvalues_dict[out_val.name] = Variable(out_val.name, [], [], None)
                    if out_val.name in stats:
                        qparams_per_value[out_val.name] = qparams_for(out_val.name, True)
                qnodes_dict[node.name] = Node(node.name, node.op, node.attrs, [], [])

        # re-link the cloned graph
        for name, qnode in qnodes_dict.items():
            qnode.inputs = [None if i is None else qvalues_dict[i.name]
                            for i in node_dict[name].inputs]
            qnode.outputs = [qvalues_dict[o.name] for o in node_dict[name].outputs]
        for name, qvalue in qvalues_dict.items():
            if isinstance(qvalue, Variable):
                qvalue.inputs = [qnodes_dict[i.name] for i in value_dict[name].inputs]
            qvalue.outputs = [qnodes_dict[o.name] for o in value_dict[name].outputs]

        qoutputs = [qvalues_dict[o.name] for o in self.outputs]
        qinputs = [qvalues_dict[i.name] for i in self.inputs]
        quantized_ops = ("MatMul", "Gemm", "Conv") if quantize_conv \
            else ("MatMul", "Gemm")
        return QModel(list(qnodes_dict.values()), list(qvalues_dict.values()),
                      qinputs, qoutputs, bit_width, qparams_per_value,
                      quantized_ops=quantized_ops, device=self.device)

    def quantize_weights(self, bit_width: int = 8, per_channel: bool = True,
                         pack: bool = None, group_size: int = None) -> int:
        """Weight-only quantization: replace 2-D float MatMul/Gemm weights
        with symmetric integer weights while compute stays float (the
        executor dequantizes per MatMul, or ``splitk_wo_matmul`` streams
        the packed payload under ``packed_execution="kernel"``). Scales
        come from the weights themselves (no calibration).

        ``per_channel``: one abs-max scale per output channel (default),
        else one per tensor. ``group_size``: one scale per
        ``group_size`` input rows x output channel, stored compactly
        [K/g, N], for weights consumed only as MatMul rhs whose K divides
        evenly (others keep per-channel scales). ``pack``: bit-pack the
        payload (default below 8 bits; split-K at 1/2/4, bit-planes
        otherwise). Mutates this float model in place and returns the
        number of converted weights."""
        if getattr(self, "quant_params", None) is not None:
            raise ValueError(
                "quantize_weights is a FLOAT-executor mode; this model is "
                "already integer-quantized (use pack_weights there)")
        if pack is None:
            pack = bit_width < 8
        converted = 0
        for value in self.values:
            if not isinstance(value, Constant) \
                    or not isinstance(value.data, FTensor) \
                    or value.data.data.ndim != 2 \
                    or not only_rhs_of(value, ("MatMul", "Gemm")):
                continue
            axes = {0 if n.op == "Gemm" and n.attrs.get("transB") else 1
                    for n in value.outputs}
            if len(axes) != 1:
                continue
            ch_axis = axes.pop()
            # grouped scales assume the MatMul [K, N] orientation
            groupable = bool(group_size) and ch_axis == 1 \
                and all(n.op == "MatMul" for n in value.outputs)
            # quantized on the host (IEEE f32 divide, as on the card),
            # packed there, then moved to the device once
            host = value.data.data.to("cpu", torch.float32)
            scale, store_scale = weight_only_scales(
                host.numpy(), bit_width, ch_axis, per_channel=per_channel,
                group_size=group_size, groupable=groupable)
            q = quantize(host, bit_width, scale, None)
            qt = QTensor(q.to(torch.int8) if bit_width <= 8 else q,
                         bit_width,
                         scale if store_scale is None else store_scale, None)
            if pack and bit_width <= 8:
                value.data = pack_qtensor(qt).to(self.device)
            else:
                value.data = QTensor(qt.data.to(self.device), bit_width,
                                     qt.scale, None)
            converted += 1
        return converted


class QModel(Model):
    """Quantized executor."""

    def __init__(self, nodes, values, inputs, outputs, bit_width: int,
                 quant_params: dict[str, QuantizationParams],
                 quantized_ops: tuple = ("MatMul", "Gemm"),
                 device: torch.device = None):
        super().__init__(nodes, values, inputs, outputs, device)
        self.bit_width = bit_width
        self.quant_params = quant_params
        self.quantized_ops = tuple(quantized_ops)
        # ops whose outputs requantize to the model bit width
        self.requantized_ops = tuple(op for op in self.quantized_ops
                                     if op in ("Gemm", "Conv"))
        # values planned for early quantization (int8_dataflow pass)
        self._int8_values: set = set()
        self._dp_cache = None

    def _device_params(self) -> dict[str, torch.Tensor]:
        """Constant payloads as executed: int8 storage for <= 8-bit
        QTensors (the JAX package's TPU-mode layout, identical values),
        precomputed column sums of MatMul weights, and packed weights
        (PackedQTensor) as they are. Built once;
        ``invalidate_params`` drops it after a payload changes."""
        if self._dp_cache is not None:
            return self._dp_cache
        params = {}
        for value in self.values:
            if not isinstance(value, Constant):
                continue
            if isinstance(value.data, QTensor):
                qt = value.data
                params[value.name] = qt.data.to(torch.int8) \
                    if qt.bit_width <= 8 else qt.data
                cs = self._weight_colsum(value)
                if cs is not None:
                    params[value.name + ".colsum"] = cs
            elif isinstance(value.data, PackedQTensor):
                # payload and its own colsum, packed, on the device
                params[value.name] = value.data.to(self.device)
        self._dp_cache = params
        return params

    def invalidate_params(self) -> None:
        self._dp_cache = None

    def _weight_colsum(self, value: Constant):
        """Column sums of a 2-D quantized weight consumed only as MatMul
        rhs: the q_matmul correction reduces them once, not per
        forward (identical integers)."""
        data = value.data.data
        if data.ndim != 2 or not only_rhs_of(value, ("MatMul",)):
            return None
        return data.to(torch.int32).sum(dim=0, keepdim=True, dtype=torch.int32)

    def _wrap_constant(self, value: Constant) -> Tensor:
        data = value.data
        if isinstance(data, QTensor):
            params = self._device_params()
            return QTensor(params[value.name], data.bit_width, data.scale,
                           data.zero_point,
                           colsum=params.get(value.name + ".colsum"))
        if isinstance(data, PackedQTensor):
            return self._device_params()[value.name]
        return super()._wrap_constant(value)

    def _wrap_input(self, array, variable: Variable) -> Tensor:
        if isinstance(array, np.ndarray) and array.dtype == np.int64:
            return ITensor(array)
        t = self._device_tensor(array)
        qp = self.quant_params[variable.name]
        if t.dtype == torch.float32:
            return quantize_tensor(FTensor(t), self.bit_width, qp.scale,
                                   qp.zero_point)
        if t.dtype == torch.int8:
            # pre-quantized with this input's calibrated params
            return QTensor(t, self.bit_width, qp.scale, qp.zero_point)
        raise ValueError(f"Array dtype {t.dtype} not supported")

    def _node_inputs(self, node: Node, data: dict[str, Tensor]) -> list[Tensor]:
        ins = []
        if node.op in self.quantized_ops:
            # quantize float inputs on the fly ("TinyqQuant")
            for idx, v in enumerate(node.inputs):
                if v is None:
                    ins.append(None)
                    continue
                t = data[v.name]
                if isinstance(t, FTensor):
                    qp = self.quant_params[v.name]
                    t = quantize_tensor(t, self.bit_width, qp.scale, qp.zero_point)
                elif (isinstance(t, QTensor)
                      and t.bit_width != self.bit_width
                      and (idx < 2 or (idx == 2
                                       and node.op == "FusedAttentionHS"))):
                    # a 4x-width accumulator OPERAND (never a bias)
                    # requantizes with this value's calibrated params
                    qp = self.quant_params[v.name]
                    t = t.requantize(self.bit_width, qp.scale, qp.zero_point)
                ins.append(t)
        elif (node.op in PASSTHROUGH_OPS
              and node.outputs
              and all(o.name in self._int8_values for o in node.outputs)
              and isinstance(data[node.inputs[0].name], QTensor)
              and data[node.inputs[0].name].bit_width == self.bit_width):
            # int8_dataflow: value-preserving shape op inside a planned
            # int8 region moves int8 data
            ins = [None if v is None else data[v.name] for v in node.inputs]
        else:
            # dequantize quantized inputs ("TinyqDequant")
            for v in node.inputs:
                if v is None:
                    ins.append(None)
                    continue
                t = data[v.name]
                if isinstance(t, QTensor):
                    t = t.dequantize()
                ins.append(t)
        return ins

    def _post_node(self, node: Node, outputs: list[Tensor]) -> list[Tensor]:
        if node.op in self.requantized_ops:
            # Gemm/Conv outputs requantize to the model bit width; MatMul
            # outputs stay 4x-bit-width accumulators
            qp = self.quant_params[node.outputs[0].name]
            outputs = [t.requantize(self.bit_width, qp.scale, qp.zero_point)
                       for t in outputs]
        if self._int8_values:
            # int8_dataflow: planned values leave their producer as int8
            outs = []
            for value, t in zip(node.outputs, outputs):
                if value.name in self._int8_values:
                    qp = self.quant_params[value.name]
                    if isinstance(t, FTensor):
                        t = quantize_tensor(t, self.bit_width, qp.scale,
                                            qp.zero_point)
                    elif isinstance(t, QTensor) \
                            and t.bit_width != self.bit_width:
                        t = t.requantize(self.bit_width, qp.scale,
                                         qp.zero_point)
                outs.append(t)
            return outs
        return outputs

    def _finalize_output(self, tensor: Tensor):
        if isinstance(tensor, FTensor):
            data = tensor.data
            return data.to(torch.float32) if data.dtype == torch.bfloat16 \
                else data
        if isinstance(tensor, QTensor):
            return tensor.dequantize().data
        raise ValueError(f"Unsupported output tensor {type(tensor)}")

    def fuse_attention(self) -> int:
        """Fuse MatMul -> scale -> Softmax -> MatMul chains with their
        head split/merge into FusedAttentionHS nodes. See
        passes/attention.py."""
        from .passes import fuse_attention
        return fuse_attention(self)

    def fuse_gelu(self) -> int:
        """Fuse the exporter's exact-GELU chain into one FusedGelu node.
        See passes/gelu.py."""
        from .passes import fuse_gelu
        return fuse_gelu(self)

    def int8_dataflow(self) -> int:
        """Plan early quantization: the residual stream stays int8. Run
        after fuse_attention(). See passes/int8_dataflow.py."""
        from .passes import int8_dataflow
        return int8_dataflow(self)

    def narrow_gather(self) -> int:
        """Dead-token elimination of the ViT CLS-token pick. See
        passes/narrow.py."""
        from .passes import narrow_gather
        return narrow_gather(self)

    def pack_weights(self) -> int:
        """Switch 2-D symmetric <= 8-bit MatMul weights to packed storage
        (exactly bit_width bits per value). See passes/weights.py."""
        from .passes import pack_weights
        return pack_weights(self)

    def optimize(self, verbose: bool = False) -> dict:
        """Apply the graph passes that keep the executor's numerics:
        attention fusion, GELU fusion, dead-token elimination and early
        int8 quantization. Returns a {pass: count} summary plus the
        Softmaxes that did not fuse (node name, reason)."""
        fused = self.fuse_attention()
        gelu = self.fuse_gelu()
        narrowed = self.narrow_gather()
        planned = self.int8_dataflow()
        failures = list(self.fusion_report["failures"])
        if verbose:
            for name, reason in failures:
                print(f"optimize: Softmax {name!r} not fused: {reason}")
        return {"fuse_attention": fused, "fuse_gelu": gelu,
                "narrow_gather": narrowed, "int8_dataflow": planned,
                "fusion_failures": failures}
