"""QModel serialization and standard-format export (port of
``numpy_quant_tpu/utils/serialization.py``).

A QModel round-trips through a single ONNX file: the source graph, its
quantized payloads as initializers (int8 to 8 bits, packed payloads as
they are stored) and the quantization parameters as ``metadata_props``
under the key ``"numpy_quant_tpu.qmodel"`` -- the JAX package's key and
layout, so a file either package writes loads in the other. Weight-only
models ride under ``"numpy_quant_tpu.weight_only"``. ``export_qdq`` and
``export_qoperator`` write the standard QDQ and QOperator formats any
ONNX runtime serves (and this package runs: ``ops/interop.py``). The
tensor-parallel stacked layout (``"splitk_stacked"``) saves and loads as
it is stored, and an export after ``merge_parallel_matmuls`` re-slices each
source weight out of the merged payload.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .. import config
from .. import onnx as O
from ..graph import Constant, import_onnx
from ..kernels.pack import (unpack_bitplanes_np, unpack_splitk_np,
                            unpack_stacked_np)
from ..model import Model, QModel, QuantizationParams
from ..tensor import PackedQTensor, QTensor

QMODEL_KEY = "numpy_quant_tpu.qmodel"
WEIGHT_ONLY_KEY = "numpy_quant_tpu.weight_only"


def save_calibration_stats(stats: dict, path) -> None:
    """Persist {value name: (min, max)} calibration stats as JSON."""
    with open(path, "w") as f:
        json.dump({k: [float(v[0]), float(v[1])] for k, v in stats.items()},
                  f, indent=0)


def load_calibration_stats(path) -> dict:
    with open(path) as f:
        raw = json.load(f)
    return {k: (np.float32(v[0]), np.float32(v[1])) for k, v in raw.items()}


def merge_calibration_stats(*stats_dicts: dict) -> dict:
    """Merge {value name: (min, max)} dicts from several calibration
    batches into one running global min/max (the reductions are
    associative, so batch-at-a-time calibration equals one big batch:
    the reference's global reduction)."""
    merged: dict = {}
    for stats in stats_dicts:
        for name, (mn, mx) in stats.items():
            if name in merged:
                omn, omx = merged[name]
                merged[name] = (np.minimum(omn, mn), np.maximum(omx, mx))
            else:
                merged[name] = (np.float32(mn), np.float32(mx))
    return merged


def _scale_to_json(scale):
    """Scalar scale -> float; per-channel vector scale -> shape+values."""
    arr = np.asarray(scale, np.float32)
    if arr.ndim == 0:
        return float(arr)
    return {"shape": list(arr.shape),
            "values": [float(v) for v in arr.reshape(-1)]}


def _scale_from_json(s):
    if isinstance(s, dict):
        return np.asarray(s["values"], np.float32).reshape(s["shape"])
    return np.float32(s)


def _qparams_to_json(qp: QuantizationParams) -> dict:
    return {"scale": _scale_to_json(qp.scale),
            "zero_point": None if qp.zero_point is None
            else int(qp.zero_point)}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _with_meta(model: O.ModelProto, key: str, meta: dict) -> None:
    entry = O.proto.StringStringEntryProto()
    entry.key = key
    entry.value = json.dumps(meta)
    model.metadata_props = [e for e in model.metadata_props
                            if e.key != key] + [entry]


def _read_meta(model: O.ModelProto, key: str) -> dict:
    return json.loads(next(e for e in model.metadata_props
                           if e.key == key).value)


def save_qmodel(qmodel: QModel, path, source_onnx: O.ModelProto,
                external_data_threshold: int = None) -> None:
    """Persist a QModel next to its source graph (the ModelProto the float
    model was imported from: its structure is reused, only constant
    payloads and metadata change). Packed payloads store verbatim;
    ``external_data_threshold`` (bytes) moves big payloads to a
    ``<path>.data`` side file, which load_qmodel reads transparently."""
    model, tensor_meta = _weight_only_initializers(qmodel, source_onnx)
    _with_meta(model, QMODEL_KEY, {
        "bit_width": qmodel.bit_width,
        "quantized_ops": [op for op in qmodel.quantized_ops
                          if op != "FusedAttention"],
        "quant_params": {k: _qparams_to_json(v)
                         for k, v in qmodel.quant_params.items()},
        "quantized_initializers": tensor_meta,
    })
    O.save(model, path, external_data_threshold=external_data_threshold)


def _weight_only_initializers(model, source_onnx):
    """The shared initializer conversion of save_qmodel/save_weight_only:
    (a deep copy of ``source_onnx`` with integer payloads, tensor_meta)."""
    out = O.load_from_string(source_onnx.SerializeToString())
    qconst = {v.name: v for v in model.values if isinstance(v, Constant)}
    new_inits, tensor_meta = [], {}
    for init in out.graph.initializer:
        value = qconst.get(init.name)
        data = None if value is None else value.data
        if isinstance(data, PackedQTensor):
            payload = _host(data.planes)
            payload = payload.astype(np.int8) \
                if payload.dtype == np.int8 else payload.astype(np.uint8)
            new_inits.append(O.from_array(payload, init.name))
            tensor_meta[init.name] = {
                "packed": True, "layout": data.layout,
                "bit_width": data.bit_width, "k": data.k, "n": data.n,
                "scale": _scale_to_json(data.scale), "zero_point": None}
        elif isinstance(data, QTensor):
            arr = _host(data.data)
            store = arr.astype(np.int8) if data.bit_width <= 8 \
                else arr.astype(np.int32)
            new_inits.append(O.from_array(store, init.name))
            tensor_meta[init.name] = {
                "bit_width": data.bit_width,
                "scale": _scale_to_json(data.scale),
                "zero_point": None if data.zero_point is None
                else int(data.zero_point)}
        else:
            new_inits.append(init)
    out.graph.initializer = new_inits
    return out, tensor_meta


def save_weight_only(model: Model, path, source_onnx: O.ModelProto) -> None:
    """Persist a weight-only model (a float ``Model`` whose MatMul/Gemm
    weights ``Model.quantize_weights`` converted): integer payloads
    (packed included) as initializers, scales -- scalar, per-channel or
    grouped [K/g, N] -- in metadata. Round-trips through
    :func:`load_weight_only` bit for bit."""
    out, tensor_meta = _weight_only_initializers(model, source_onnx)
    _with_meta(out, WEIGHT_ONLY_KEY, {"quantized_initializers": tensor_meta})
    O.save(out, path)


def load_weight_only(path, device=None) -> Model:
    """Load a float weight-only model saved by save_weight_only, on
    ``device`` (CUDA unless the caller passes another)."""
    dev = config.resolve_device(device)
    model_proto = O.load(path)
    meta = _read_meta(model_proto, WEIGHT_ONLY_KEY)
    nodes, values, inputs, outputs = import_onnx_quantized(
        model_proto, meta["quantized_initializers"], dev,
        narrow_storage=True)
    return Model(nodes, values, inputs, outputs, dev)


def load_qmodel(path, device=None) -> QModel:
    """Load a QModel saved by save_qmodel (by either package), on
    ``device`` (CUDA unless the caller passes another)."""
    dev = config.resolve_device(device)
    model_proto = O.load(path)
    meta = _read_meta(model_proto, QMODEL_KEY)
    tensor_meta = meta["quantized_initializers"]
    bit_width = int(meta["bit_width"])
    # a width above 8 (activations or weights; 4x-width biases aside)
    # computes in x64-mode numerics, int64 containers, as Model.quantize
    # decides it
    wide = bit_width > 8 or any(
        8 < m["bit_width"] <= 16 and m["bit_width"] != 4 * bit_width
        for m in tensor_meta.values())
    container = torch.int64 if wide else torch.int32
    nodes, values, inputs, outputs = import_onnx_quantized(
        model_proto, tensor_meta, dev, container=container)
    qparams = {
        name: QuantizationParams(
            _scale_from_json(d["scale"]),
            None if d["zero_point"] is None else np.int64(d["zero_point"]))
        for name, d in meta["quant_params"].items()}
    quantized_ops = tuple(meta.get("quantized_ops", ("MatMul", "Gemm")))
    return QModel(nodes, values, inputs, outputs, bit_width, qparams,
                  quantized_ops=quantized_ops, device=dev,
                  container=container)


def _packed_values(planes: np.ndarray, layout: str, bits: int,
                   k: int) -> np.ndarray:
    """A packed payload's integer values [K, N] (host)."""
    if layout == "splitk_stacked":
        return unpack_stacked_np(planes, bits, k)
    if layout == "splitk":
        return planes.astype(np.int8) if bits == 8 \
            else unpack_splitk_np(planes, bits, k)
    return unpack_bitplanes_np(planes, bits, k)


def import_onnx_quantized(model_proto: O.ModelProto, tensor_meta: dict,
                          device, container=torch.int32,
                          narrow_storage: bool = False):
    """graph.import_onnx with the quantized constants of ``tensor_meta``
    rebuilt: QTensors in ``container`` (int8 at <= 8 bits with
    ``narrow_storage``, the weight-only layout) and PackedQTensors with
    their column sums, on ``device``."""
    dev = torch.device(device)

    def constant(name, arr):
        meta = tensor_meta.get(name)
        if meta is None:
            return None
        bits = meta["bit_width"]
        if meta.get("packed"):
            layout = meta.get("layout", "bitplanes")
            planes = arr.astype(np.int8) \
                if layout != "bitplanes" and bits == 8 \
                else arr.astype(np.uint8)
            vals = _packed_values(planes, layout, bits, meta["k"])
            colsum = vals.astype(np.int64).sum(
                axis=0, keepdims=True).astype(np.int32)
            return PackedQTensor(torch.from_numpy(planes).to(dev),
                                 torch.from_numpy(colsum).to(dev),
                                 meta["k"], meta["n"], bits,
                                 _scale_from_json(meta["scale"]),
                                 layout=layout)
        dtype = np.int8 if narrow_storage and bits <= 8 else (
            np.int64 if container == torch.int64 else np.int32)
        zp = meta["zero_point"]
        return QTensor(torch.from_numpy(arr.astype(dtype)).to(dev), bits,
                       _scale_from_json(meta["scale"]),
                       None if zp is None else np.int64(zp))

    return import_onnx(model_proto, dev, constant=constant)


def _unpack_packed(data):
    """PackedQTensor -> the equal-value plain QTensor (host payload);
    anything else passes through."""
    if not isinstance(data, PackedQTensor):
        return data
    vals = _packed_values(_host(data.planes), data.layout, data.bit_width,
                          data.k)
    return QTensor(torch.from_numpy(np.ascontiguousarray(vals)),
                   data.bit_width, data.scale, None)


def _merged_weight_slices(qmodel: QModel) -> dict:
    """{source weight name: its QTensor} re-sliced out of each merged
    MatMulSplit payload (merge_parallel_matmuls removed the sources), so
    an export carries the integers the executor computes with (JAX
    ``utils/serialization.py:281-301``)."""
    out = {}
    for node in qmodel.nodes:
        if node.op != "MatMulSplit" or "source_weights" not in node.attrs:
            continue
        mdata = _unpack_packed(node.inputs[1].data)
        vals = _host(mdata.data)
        start = 0
        for name, seg, sc in zip(node.attrs["source_weights"],
                                 node.attrs["segments"],
                                 node.attrs["segment_scales"]):
            out[name] = QTensor(torch.from_numpy(np.ascontiguousarray(
                vals[:, start:start + seg])), mdata.bit_width,
                np.float32(sc), None)
            start += seg
    return out


def _per_channel_axis(v, arr: np.ndarray, scale: np.ndarray) -> int:
    """Channel axis of a per-channel weight's DequantizeLinear, from the
    CONSUMER (the per_channel_weights rule: MatMul rhs -> axis 1, Gemm
    transB -> axis 0; a square weight makes shape matching ambiguous);
    shape matching for 1-D biases."""
    axis = None
    if arr.ndim == 2:
        for n in getattr(v, "outputs", None) or []:
            if n.op == "Gemm":
                axis = 0 if n.attrs.get("transB") else 1
            elif n.op == "MatMul":
                axis = 1
    if axis is None or axis >= arr.ndim or arr.shape[axis] != scale.size:
        axis = next(i for i, d in enumerate(arr.shape) if d == scale.size)
    return axis


def _quantized_initializers(qmodel: QModel, g):
    """Each quantized symmetric initializer of ``g`` as (init, value,
    integer payload, flat scale, stored array); other initializers as
    (init, None, ...)."""
    qconst = {v.name: v for v in qmodel.values if isinstance(v, Constant)}
    merged = _merged_weight_slices(qmodel)
    for init in g.initializer:
        v = qconst.get(init.name)
        data = getattr(v, "data", None)
        if data is None and init.name in merged:
            v, data = None, merged[init.name]
        data = _unpack_packed(data)
        if not isinstance(data, QTensor) or data.zero_point is not None:
            yield init, None, None, None, None
            continue
        arr = _host(data.data)
        scale = np.asarray(data.scale, np.float32).reshape(-1)
        # <= 8-bit payloads store int8; 4x-bit-width biases int32
        store = arr.astype(np.int8) if data.bit_width <= 8 \
            else arr.astype(np.int32)
        yield init, v, data, scale, store


def _wrappable(p) -> bool:
    """Only activation-bit-width params export as int8 Q/DQ pairs; 4x-bit
    accumulator entries (wide zero points) and per-channel ones do not."""
    if p is None or np.asarray(p.scale).size > 1:
        return False
    zp = p.zero_point
    return zp is None or -128 <= int(zp) <= 127


class _QDQWriter:
    """The Q/DQ node and initializer bookkeeping the two exports share."""

    def __init__(self, qp):
        self.qp = qp
        self.extra_inits = []
        self.new_nodes = []
        self.wrapped: dict[str, str] = {}

    def param_inits(self, name: str, p, suffix: str = "qdq") -> list:
        sname = f"{name}/{suffix}_scale"
        self.extra_inits.append(O.from_array(np.float32(p.scale), sname))
        # ALWAYS an int8 zero point: without one, ONNX QuantizeLinear
        # defaults to uint8 storage and a conformant runtime would clip
        # every negative value to 0 (symmetric exports zp 0)
        zname = f"{name}/{suffix}_zp"
        zp_val = 0 if p.zero_point is None else int(p.zero_point)
        self.extra_inits.append(O.from_array(np.int8(zp_val), zname))
        return [sname, zname]

    def ensure_qdq(self, name: str) -> str:
        """Consumer-side wrap: Q/DQ after the existing value."""
        if name in self.wrapped:
            return self.wrapped[name]
        p = self.qp.get(name)
        if not _wrappable(p):
            return name
        pnames = self.param_inits(name, p)
        qout, dqout = f"{name}/qdq_q", f"{name}/qdq"
        self.new_nodes.append(O.make_node(
            "QuantizeLinear", [name] + pnames, [qout], name=f"Q_{name}"))
        self.new_nodes.append(O.make_node(
            "DequantizeLinear", [qout] + pnames, [dqout], name=f"DQ_{name}"))
        self.wrapped[name] = dqout
        return dqout

    def wrap_producer(self, node) -> None:
        """Producer-side wrap: the node emits '<out>/raw', the DQ re-emits
        the ORIGINAL name, so downstream needs no renames."""
        out = node.output[0]
        p = self.qp.get(out)
        if not _wrappable(p):
            return
        raw = out + "/raw"
        node.output[0] = raw
        pnames = self.param_inits(out, p)
        self.new_nodes.append(O.make_node(
            "QuantizeLinear", [raw] + pnames, [out + "/q"], name=f"Q_{out}"))
        self.new_nodes.append(O.make_node(
            "DequantizeLinear", [out + "/q"] + pnames, [out],
            name=f"DQ_{out}"))
        # the re-emitted name already carries fake-quant values: later
        # consumer-side wraps reuse it (a re-wrap would duplicate names
        # and is the identity)
        self.wrapped[out] = out


def export_qdq(qmodel: QModel, source_onnx: O.ModelProto) -> O.ModelProto:
    """Export a QModel as a standard QDQ-format ONNX model
    (QuantizeLinear/DequantizeLinear) that any ONNX runtime serves:
    quantized weights become int8 initializers + DequantizeLinear
    (per-tensor or per-axis scales), 4x-bit-width biases int32
    initializers + DequantizeLinear at the s_x*s_w scale, graph inputs
    and MatMul/Gemm activations get Q/DQ pairs with the calibrated
    params, and Gemm outputs requantize through a Q/DQ pair (renamed on
    the producer side, so the interface keeps its names). Needs
    bit_width <= 8."""
    assert qmodel.bit_width <= 8, "QDQ export needs bit_width <= 8"
    model = O.load_from_string(source_onnx.SerializeToString())
    g = model.graph
    new_inits, weight_dq_nodes = [], []
    for init, v, data, scale, store in _quantized_initializers(qmodel, g):
        if data is None:
            new_inits.append(init)  # float/shape-domain constants as-is
            continue
        qname, sname = init.name + "/q", init.name + "/q_scale"
        new_inits.append(O.from_array(store, qname))
        kw = {}
        if scale.size > 1:
            new_inits.append(O.from_array(scale.astype(np.float32), sname))
            kw["axis"] = _per_channel_axis(v, store, scale)
        else:
            new_inits.append(O.from_array(np.float32(scale[0]), sname))
        weight_dq_nodes.append(O.make_node(
            "DequantizeLinear", [qname, sname], [init.name],
            name=f"DQ_{init.name}", **kw))
    init_names = {i.name for i in new_inits} | \
        {n.output[0] for n in weight_dq_nodes}

    w = _QDQWriter(qmodel.quant_params)
    w.new_nodes.extend(weight_dq_nodes)
    # graph inputs quantize on entry: EVERY consumer sees the fake-quant
    # value
    rename = {vi.name: w.ensure_qdq(vi.name) for vi in g.input
              if vi.name not in init_names}
    for node in g.node:
        node.input = [rename.get(i, i) for i in node.input]
        if node.op_type in ("MatMul", "Gemm"):
            # activations quantize per matmul; other consumers of the same
            # value keep the float original
            node.input = [i if i in init_names else w.ensure_qdq(i)
                          for i in node.input]
        w.new_nodes.append(node)
        if node.op_type == "Gemm" and node.output[0] in qmodel.quant_params:
            w.wrap_producer(node)  # the Gemm output requantize
    model.graph.node = w.new_nodes
    model.graph.initializer = new_inits + w.extra_inits
    return model


def save_qmodel_qdq(qmodel: QModel, path, source_onnx: O.ModelProto) -> None:
    """export_qdq + save: one standard ONNX file other runtimes serve."""
    O.save(export_qdq(qmodel, source_onnx), path)


def export_qoperator(qmodel: QModel,
                     source_onnx: O.ModelProto) -> O.ModelProto:
    """Export a QModel in QOperator format: quantized MatMuls become
    QLinearMatMul and quantized Convs QLinearConv, so runtimes without QDQ
    pattern fusion still run integer kernels. Activations enter each
    converted op through a shared QuantizeLinear with the calibrated
    params; its int8 output dequantizes back under the original value
    name. Gemm (the standard opset has no quantized Gemm) and any MatMul
    the format cannot express (per-channel weights: QLinearMatMul takes
    scalar operand scales) keep export_qdq's form. The format requantizes
    each converted op's output where the executor carries the exact int32
    accumulator, one more rounding per converted node. Needs
    bit_width <= 8."""
    assert qmodel.bit_width <= 8, "QOperator export needs bit_width <= 8"
    model = O.load_from_string(source_onnx.SerializeToString())
    g = model.graph
    new_inits = []
    weight_q = {}         # float init name -> (qname, sname, zname, QTensor)
    weight_dq_nodes = {}  # float init name -> DequantizeLinear node
    for init, v, data, scale, store in _quantized_initializers(qmodel, g):
        if data is None:
            new_inits.append(init)
            continue
        qname, sname, zname = (init.name + "/q", init.name + "/q_scale",
                               init.name + "/q_zp")
        new_inits.append(O.from_array(store, qname))
        sval = scale.astype(np.float32) if scale.size > 1 \
            else np.float32(scale[0])
        new_inits.append(O.from_array(sval, sname))
        if store.dtype == np.int8:
            zval = np.zeros(scale.shape, np.int8) if scale.size > 1 \
                else np.int8(0)
            new_inits.append(O.from_array(zval, zname))
        else:
            zname = None  # int32 biases carry no zero point input
        weight_q[init.name] = (qname, sname, zname, data)
        kw = {}
        if scale.size > 1:
            kw["axis"] = _per_channel_axis(v, store, scale)
        dq_in = [qname, sname] + ([zname] if zname else [])
        weight_dq_nodes[init.name] = O.make_node(
            "DequantizeLinear", dq_in, [init.name], name=f"DQ_{init.name}",
            **kw)
    init_names = {i.name for i in new_inits} | set(weight_dq_nodes)

    qp = qmodel.quant_params
    w = _QDQWriter(qp)
    quantized_act: dict[str, tuple] = {}

    def ensure_q(name: str):
        """int8 activation for a QLinear operand: one QuantizeLinear
        shared by every converted consumer; (q name, scale, zp) or None."""
        p = qp.get(name)
        if not _wrappable(p):
            return None
        if name not in quantized_act:
            pnames = w.param_inits(name, p, suffix="qop")
            qout = f"{name}/qop_q"
            w.new_nodes.append(O.make_node(
                "QuantizeLinear", [name] + pnames, [qout],
                name=f"Qop_{name}"))
            quantized_act[name] = (qout, pnames[0], pnames[1])
        return quantized_act[name]

    def qlinear_operand(name: str):
        """(int8 name, scale name, zp name) of a QLinear input: a quantized
        weight initializer directly, or an activation through its shared
        QuantizeLinear."""
        wq = weight_q.get(name)
        if wq is not None:
            qname, sname, zname, data = wq
            if zname is None or np.asarray(data.scale).ndim > 0:
                return None  # bias payload / per-channel: not scalar
            return (qname, sname, zname)
        if name in init_names:
            return None  # unquantized initializer
        return ensure_q(name)

    def qlinear_node(op, ins, node, out, p_out):
        ynames = w.param_inits(out, p_out, suffix="qop_y")
        if op == "QLinearConv" and len(ins) > 6:
            ins = ins[:6] + ynames + ins[6:]
        else:
            ins = ins + ynames
        qnode = O.make_node(op, ins, [out + "/qop"],
                            name=f"QL_{node.name or out}")
        if op == "QLinearConv":
            for a in node.attribute:
                qnode.attribute.append(a)
        w.new_nodes.append(qnode)
        w.new_nodes.append(O.make_node(
            "DequantizeLinear", [out + "/qop"] + ynames, [out],
            name=f"QLDQ_{out}"))

    # graph inputs quantize on entry for QDQ-fallback consumers
    rename = {vi.name: w.ensure_qdq(vi.name) for vi in g.input
              if vi.name not in init_names}
    for node in g.node:
        out = node.output[0] if node.output else None
        p_out = qp.get(out)
        if node.op_type == "MatMul":
            qa = qlinear_operand(node.input[0])
            qb = qlinear_operand(node.input[1])
            if qa and qb and _wrappable(p_out):
                qlinear_node("QLinearMatMul", list(qa) + list(qb), node,
                             out, p_out)
                continue
        if node.op_type == "Conv" and "Conv" in qmodel.quantized_ops:
            bias = node.input[2] if len(node.input) > 2 else None
            qx = qlinear_operand(node.input[0])
            wq = weight_q.get(node.input[1])
            bias_ok = bias is None or (
                bias in weight_q and weight_q[bias][2] is None)
            if qx and wq and wq[2] is not None and bias_ok \
                    and _wrappable(p_out):
                # per-channel weight scales are legal for QLinearConv
                ins = list(qx) + [wq[0], wq[1], wq[2]]
                if bias is not None:
                    ins.append(weight_q[bias][0])
                qlinear_node("QLinearConv", ins, node, out, p_out)
                continue
        # unconverted: export_qdq's form
        node.input = [rename.get(i, i) for i in node.input]
        if node.op_type in ("MatMul", "Gemm"):
            node.input = [i if i in init_names else w.ensure_qdq(i)
                          for i in node.input]
        w.new_nodes.append(node)
        if node.op_type == "Gemm" and out in qp:
            w.wrap_producer(node)

    # keep a float-rebuilding DequantizeLinear only for the quantized
    # initializers some remaining node (or the graph output) reads
    used = {i for n in w.new_nodes for i in n.input}
    out_names = {o.name for o in g.output}
    dq_keep = [dq for name, dq in weight_dq_nodes.items() if name in used]
    dq_keep += [dq for name, dq in weight_dq_nodes.items()
                if name in out_names and name not in used]
    model.graph.node = dq_keep + w.new_nodes
    model.graph.initializer = new_inits + w.extra_inits
    return model


def save_qmodel_qoperator(qmodel: QModel, path,
                          source_onnx: O.ModelProto) -> None:
    """export_qoperator + save: one QOperator-format ONNX file."""
    O.save(export_qoperator(qmodel, source_onnx), path)


__all__ = ["export_qdq", "export_qoperator", "import_onnx_quantized",
           "load_calibration_stats", "load_qmodel", "load_weight_only",
           "merge_calibration_stats", "save_calibration_stats",
           "save_qmodel", "save_qmodel_qdq", "save_qmodel_qoperator",
           "save_weight_only"]
