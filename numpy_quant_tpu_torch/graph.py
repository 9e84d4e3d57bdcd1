"""Graph IR and ONNX importer (port of ``numpy_quant_tpu/graph.py``):
doubly-linked Constant/Variable/Node objects in ONNX graph order. Float
initializers become FTensors on the model's device, and a float Constant
node's value is placed there too (its ``placed`` attr); integer
initializers become host ITensors (the shape domain), narrow ones (int8,
uint8, int16, uint16: QDQ payloads) keeping their dtype and a device
copy."""
from __future__ import annotations

from typing import Any, List, Union

import numpy as np
import torch

from . import onnx as onnx_lib
from .tensor import FTensor, ITensor, Tensor


class Constant:
    def __init__(self, name: str, outputs: List["Node"], data: Tensor = None):
        self.name = name
        self.outputs = outputs
        self.data = data

    def __repr__(self):
        return f"Constant({self.name})"


class Variable:
    def __init__(self, name: str, inputs: List["Node"], outputs: List["Node"],
                 data: Tensor = None):
        self.name = name
        self.inputs = inputs
        self.outputs = outputs
        self.data = data

    def __repr__(self):
        return f"Variable({self.name})"


Value = Union[Constant, Variable]


class Node:
    def __init__(self, name: str, op: str, attrs: dict[str, Any],
                 inputs: List[Value], outputs: List[Value]):
        self.name = name
        self.op = op
        self.attrs = attrs
        self.inputs = inputs
        self.outputs = outputs

    def __repr__(self):
        return f"Node({self.name})"


def only_rhs_of(value: Value, ops: tuple) -> bool:
    """Whether every consumer of ``value`` is an ``ops`` node taking it as
    input 1 (a weight: MatMul/Gemm rhs)."""
    return bool(value.outputs) and all(
        n.op in ops and len(n.inputs) > 1 and n.inputs[1] is value
        for n in value.outputs)


def attribute_to_python(attr) -> Any:
    """ONNX attribute -> python/numpy value."""
    value = onnx_lib.get_attribute_value(attr)
    if isinstance(value, onnx_lib.TensorProto):
        return onnx_lib.to_array(value)
    return value


# ops whose integer inputs are quantized payloads read on the device
QUANT_INT_CONSUMERS = ("DequantizeLinear", "QLinearMatMul", "QLinearConv",
                       "MatMulInteger")
_NARROW = (np.int8, np.uint8, np.int16, np.uint16)


def wrap_array(arr: np.ndarray, device: torch.device,
               place: bool = False) -> Tensor:
    """Classify a host array into the tensor layer. Narrow integer payloads
    (QDQ-format weights and zero points) widen to the host int64 domain and
    keep their dtype as ``orig_dtype``; they, and the integer arrays a
    quantized op consumes (``place``, e.g. int32 biases), are also placed
    on the device once (int8 stays int8, the rest int32). Small float
    arrays (at most 64 values, or 1-D) keep a host copy, ``host``, for the
    ops that read scales on the host."""
    arr = np.asarray(arr)
    if arr.dtype == np.float32:
        t = FTensor(torch.from_numpy(np.array(arr)).to(device))
        if arr.size <= 64 or arr.ndim == 1:
            t.host = arr
        return t
    narrow = arr.dtype in _NARROW
    if narrow or arr.dtype in (np.int64, np.int32, np.bool_):
        placed = None
        if narrow or place:
            placed = torch.from_numpy(arr.astype(
                np.int8 if arr.dtype == np.int8 else np.int32)).to(device)
        return ITensor(arr.astype(np.int64),
                       orig_dtype=arr.dtype if narrow else None,
                       placed=placed)
    raise ValueError(f"Array dtype {arr.dtype} not supported")


def import_onnx(onnx_model: onnx_lib.ModelProto, device: torch.device,
                constant=None):
    """Build (nodes, values, inputs, outputs) from a ModelProto. A graph
    input that is also an initializer stays a Constant. ``constant(name,
    array)``: the tensor of an initializer, or None to classify it with
    ``wrap_array`` (utils/serialization.py rebuilds quantized payloads)."""
    return import_graph(onnx_model.graph, device, constant)


def import_graph(graph: onnx_lib.GraphProto, device: torch.device,
                 constant=None):
    """The body of :func:`import_onnx`, also used for the If/Loop body
    graphs (attributes), which ``Model`` runs against the enclosing
    values; a name the body does not define becomes a Variable that reads
    the enclosing scope."""
    value_dict: dict[str, Value] = {}
    initializer_names = set()
    quant_ins = {name for n in graph.node if n.op_type in QUANT_INT_CONSUMERS
                 for name in n.input}
    for onnx_tensor in graph.initializer:
        arr = onnx_lib.to_array(onnx_tensor)
        data = None if constant is None else constant(onnx_tensor.name, arr)
        if data is None:
            data = wrap_array(arr, device,
                              place=onnx_tensor.name in quant_ins)
        value_dict[onnx_tensor.name] = Constant(onnx_tensor.name, outputs=[],
                                                data=data)
        initializer_names.add(onnx_tensor.name)

    inputs: List[Variable] = []
    for onnx_vi in graph.input:
        if onnx_vi.name in initializer_names:
            continue
        var = Variable(onnx_vi.name, inputs=[], outputs=[])
        # static-shape hint (symbolic dims become None): narrow_gather
        # probes the graph's shapes from these
        dims = onnx_lib.value_info_shape(onnx_vi)
        var.shape_hint = None if dims is None else tuple(
            None if isinstance(d, str) else int(d) for d in dims)
        tt = onnx_vi.type.tensor_type if onnx_vi.type else None
        var.dtype_hint = int(tt.elem_type) if tt is not None else None
        value_dict[onnx_vi.name] = var
        inputs.append(var)

    nodes: dict[str, Node] = {}
    for i, onnx_node in enumerate(graph.node):
        name = onnx_node.name or f"{onnx_node.op_type}_{i}"
        for input_name in onnx_node.input:
            if input_name and input_name not in value_dict:
                value_dict[input_name] = Variable(input_name, inputs=[], outputs=[])
        # an empty name is an absent optional input: keep its position
        in_values = [value_dict[n] if n else None for n in onnx_node.input]
        while in_values and in_values[-1] is None:
            in_values.pop()
        attrs = {a.name: attribute_to_python(a) for a in onnx_node.attribute}
        value = attrs.get("value")
        if onnx_node.op_type == "Constant" and isinstance(value, np.ndarray) \
                and value.dtype == np.float32:
            # placed on the device once, as the float initializers are; the
            # passes read the host value
            attrs["placed"] = torch.from_numpy(np.array(value)).to(device)
        node = Node(
            name=name,
            op=onnx_node.op_type,
            attrs=attrs,
            inputs=in_values,
            outputs=[],
        )
        for input_name in onnx_node.input:
            if input_name:
                value_dict[input_name].outputs.append(node)
        for output_name in onnx_node.output:
            if output_name not in value_dict:
                value_dict[output_name] = Variable(output_name, inputs=[node],
                                                   outputs=[])
            else:
                value_dict[output_name].inputs.append(node)
        node.outputs = [value_dict[n] for n in onnx_node.output]
        nodes[name] = node

    outputs: List[Value] = [value_dict[vi.name] for vi in graph.output]
    return list(nodes.values()), list(value_dict.values()), inputs, outputs
