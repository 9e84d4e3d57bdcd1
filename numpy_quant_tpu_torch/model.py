"""Model / QModel: ONNX graph import, execution, calibration and PTQ
(port of ``numpy_quant_tpu/model.py``).

The forward is a walk over the graph's nodes on the model's device that
frees each value after its last consumer (as XLA frees the buffers of
JAX's one compiled program). On CUDA, ``__call__`` runs it as JAX runs
its one jitted program per input signature: the first call of a
signature walks once (the warm-up), captures the walk into a
``torch.cuda.CUDAGraph`` and replays it; later calls copy the inputs into
the graph's own input buffers and replay (``graph_key`` names the
signature). On the CPU, under ``record=``/``profile=`` and under
``config.eager_forward`` the walk runs eagerly.
``QModel`` quantizes float inputs of the integer ops on the fly,
dequantizes quantized inputs of every other op, requantizes Gemm/Conv
outputs and dequantizes quantized graph outputs -- the reference
executor's boundary rules, unchanged.
"""
from __future__ import annotations

import weakref
from time import perf_counter
from typing import List

import numpy as np
import torch

from . import config
from . import kernels as _kernels
from . import onnx as onnx_lib
from .graph import (Constant, Node, Value, Variable, import_graph,
                    import_onnx, only_rhs_of)
from .ops.interop import executing_on
from .ops.registry import onnx_operator_implementation
from .passes.toolkit import PASSTHROUGH_OPS
from .quantization import (container_dtype, per_channel_scales,
                           percentile_range, quant_parameters, quantize,
                           weight_only_scales)
from .tensor import (
    DITensor,
    FTensor,
    ITensor,
    PackedQTensor,
    QTensor,
    Tensor,
    pack_qtensor,
    quantize_tensor,
)


def _moved(t, device):
    """A placed constant (FTensor / QTensor / PackedQTensor) on
    ``device``."""
    if isinstance(t, PackedQTensor):
        return t.to(device)
    if isinstance(t, QTensor):
        zp = t.zero_point
        if isinstance(zp, torch.Tensor):
            zp = zp.to(device)
        return QTensor(t.data.to(device), t.bit_width, t.scale, zp,
                       colsum=None if t.colsum is None
                       else t.colsum.to(device))
    out = FTensor(t.data.to(device))
    if getattr(t, "host", None) is not None:
        out.host = t.host
    return out


class QuantizationParams:
    """(scale, zero_point) record."""

    def __init__(self, scale, zero_point):
        self.scale = scale
        self.zero_point = zero_point

    def __repr__(self):
        return f"QuantizationParams(scale={self.scale}, zero_point={self.zero_point})"


class _ScopeChain:
    """Name lookup over nested control-flow scopes: the inner body's values
    first, then the enclosing ones."""

    def __init__(self, inner, outer):
        self._inner, self._outer = inner, outer

    def __getitem__(self, name):
        try:
            return self._inner[name]
        except KeyError:
            return self._outer[name]


def _captures(graph) -> set:
    """The names a body graph (and the bodies nested in it) reads from its
    enclosing scope."""
    defined = {t.name for t in graph.initializer} \
        | {v.name for v in graph.input} \
        | {o for n in graph.node for o in n.output}
    used = set()
    for n in graph.node:
        used.update(i for i in n.input if i)
        for a in n.attribute:
            bodies = ([a.g] if a.g is not None else []) + list(a.graphs or ())
            for g in bodies:
                used |= _captures(g)
    return used - defined


def _node_captures(node) -> set:
    """Enclosing-scope names an If/Loop node's bodies read."""
    out = set()
    for v in node.attrs.values():
        if isinstance(v, onnx_lib.GraphProto):
            out |= _captures(v)
    return out


def _is_shape_input(array) -> bool:
    """An int64 host array: a shape-domain input, static in a capture."""
    return isinstance(array, np.ndarray) and array.dtype == np.int64


def graph_key(inputs: list, device) -> tuple:
    """The signature one captured forward serves (JAX's jit-cache key,
    ``numpy_quant_tpu/model.py``): each float or tensor input's shape and
    dtype, each int64 input's (shape, bytes) -- its values are baked into
    the walk --, ``config.float_dtype``, ``config.packed_execution`` and
    the device."""
    slots = []
    for i, a in enumerate(inputs):
        if _is_shape_input(a):
            slots.append((i, "int64", a.shape, a.tobytes()))
        else:
            dtype = str(a.dtype).removeprefix("torch.")
            slots.append((i, dtype, tuple(a.shape)))
    return (tuple(slots), config.float_dtype, config.packed_execution,
            str(torch.device(device)))


class _Captured:
    """One captured forward: its graph, its input buffers by input
    position (a bound input is the caller's own tensor), its output
    tensors, the launches one replay makes, the data pointers and strides
    of the bound inputs, and the capture's wall seconds."""

    def __init__(self, graph, inputs: dict, outputs: list, launches: tuple,
                 bound: tuple, seconds: float):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.bound = bound
        self.seconds = seconds


def _bound(arrays: list, inplace: tuple) -> tuple:
    return tuple((i, arrays[i].data_ptr(), tuple(arrays[i].stride()))
                 for i in inplace)


def _warm_up(fn, floats: list, device):
    """Walk ``fn(floats)`` once on a side stream, which it returns: kernels
    built, weights and host arrays placed, cuBLAS set up on the stream the
    capture then uses."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn(floats)
    torch.cuda.current_stream(device).wait_stream(stream)
    return stream


def _capture_graph(fn, floats: list, stream, pool) -> tuple:
    """(graph, outputs): ``fn(floats)`` captured on ``stream`` into a
    CUDAGraph whose memory comes from ``pool``. The graph keeps its
    cudaGraph_t beside the instantiated one, so its nodes can be read
    (utils/profiling.py::graph_kernels)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        outputs = fn(floats)
    return graph, outputs


def capture_walk(fn, floats: list, device, pool, failed=None) -> tuple:
    """(graph, outputs, launches): ``fn(floats)`` warmed up
    (:func:`_warm_up`) and captured (:func:`_capture_graph`). The warm-up
    and the capture leave the launch counters as they were; ``launches``
    is what each replay adds (kernels.add_launch_counts). ``failed(exc)``,
    if given, makes the error raised for a capture that fails."""
    before = _kernels.launch_counts()
    try:
        stream = _warm_up(fn, floats, device)
        warm = _kernels.launch_counts()
        try:
            graph, outputs = _capture_graph(fn, floats, stream, pool)
        except Exception as exc:
            if failed is None:
                raise
            raise failed(exc) from exc
        launches = _kernels.launch_delta(_kernels.launch_counts(), warm)
    finally:
        _kernels.set_launch_counts(before)
    return graph, outputs, launches


class Model:
    def __init__(self, nodes: list[Node], values: list[Value],
                 inputs: List[Variable], outputs: List[Value],
                 device: torch.device):
        self.nodes = nodes
        self.values = values
        self.inputs = inputs
        self.outputs = outputs
        self.device = torch.device(device)
        # captured forwards by graph_key, sharing one memory pool
        self._graphs: dict = {}
        self._graph_pool = None
        self._failed = None  # (node, error) where a capture failed
        self._subgraphs: dict = {}  # If/Loop bodies, imported once
        self._ring_state: dict = {}  # serve_ring sessions running
        # tensor/data parallelism (parallel/sharding.py::shard_model)
        self.mesh = None
        self.data_axis = None
        self.model_axis = "model"
        self._shard_rules = None
        self._shards = None  # (specs, local constants), built on first use
        # {input or output name: layout} of values a sharded walk takes and
        # hands back as this rank's piece (utils/generate.py's KV caches)
        self._local_io: dict = {}

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
        if t.dtype == torch.int64:
            return DITensor(t)  # device token ids: keyed by shape, not value
        raise ValueError(f"Array dtype {t.dtype} not supported")

    def _wrap_constant(self, value: Constant) -> Tensor:
        if isinstance(value.data, FTensor):
            # re-wrapped per forward: casts to the current float dtype; the
            # host copy of a small constant rides along (scales read on
            # the host: ops/interop.py)
            t = FTensor(value.data.data)
            host = getattr(value.data, "host", None)
            if host is not None:
                t.host = host
            return t
        return value.data

    # ------------------------------------------------------------------
    # Node walk
    # ------------------------------------------------------------------

    def _node_inputs(self, node: Node, data: dict[str, Tensor],
                     timings=None) -> list[Tensor]:
        return [None if v is None else data[v.name] for v in node.inputs]

    def _post_node(self, node: Node, outputs: list[Tensor]) -> list[Tensor]:
        return outputs

    def _profile_buckets(self) -> dict[str, float]:
        return {op: 0.0 for op in {n.op for n in self.nodes}}

    def _sync(self) -> None:
        """Wait for the device (profile mode's per-node timing)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _last_uses(self) -> dict[int, list[str]]:
        """{node index: names of the values whose last consumer it is}:
        every value but the graph outputs, and a value no node consumes
        at the node that produces it."""
        keep = {o.name for o in self.outputs}
        last: dict[str, int] = {}
        for i, node in enumerate(self.nodes):
            for v in node.inputs:
                if v is not None:
                    last[v.name] = i
            if node.op in ("If", "Loop"):
                # the bodies read enclosing values by name
                for name in _node_captures(node):
                    last[name] = i
            for o in node.outputs:
                last.setdefault(o.name, i)
        by_node: dict[int, list[str]] = {}
        for name, i in last.items():
            if name not in keep:
                by_node.setdefault(i, []).append(name)
        return by_node

    def _forward(self, input_tensors: dict[str, Tensor],
                 record: bool = False, visit=None,
                 timings=None) -> dict[str, Tensor]:
        """Walk the nodes; returns the live values by name. Each value is
        dropped after its last consumer (graph outputs are kept), as the
        JAX package's compiled program frees each buffer, unless
        ``record`` stores every value in ``value.data``. ``visit(name,
        tensor)`` sees every value once, as it is made (constants and
        inputs first). ``timings`` ({op type: seconds}) adds each node's
        wall time, the device synchronized around it (profile mode)."""
        data: dict[str, Tensor] = {}
        walk = self._sharded_walk()
        for value in self.values:
            if isinstance(value, Constant):
                data[value.name] = self._wrap_constant(value) \
                    if walk is None \
                    else walk.constant(value, self._local_constant(value))
        if walk is not None:
            input_tensors = {name: walk.input(name, t)
                             for name, t in input_tensors.items()}
        data.update(input_tensors)
        if visit is not None:
            for name, tensor in data.items():
                visit(name, tensor)
        last_uses = {} if record else self._last_uses()
        with executing_on(self.device):
            for i, node in enumerate(self.nodes):
                try:
                    ins = self._node_inputs(node, data, timings)
                    if timings is not None:
                        self._sync()
                        start = perf_counter()
                    outs = self._run_node(node, ins, data) \
                        if walk is None else walk.run(node, ins)
                    outs = self._post_node(node, outs)
                    if timings is not None:
                        self._sync()
                        timings[node.op] += perf_counter() - start
                except Exception as exc:
                    if self.device.type == "cuda" \
                            and torch.cuda.is_current_stream_capturing():
                        self._failed = (node, exc)
                    raise
                for o, tensor in zip(node.outputs, outs):
                    data[o.name] = tensor
                    if record:
                        o.data = tensor
                    if visit is not None:
                        visit(o.name, tensor)
                ins = outs = None
                for name in last_uses.get(i, ()):
                    data.pop(name, None)
        if walk is not None:
            # every rank returns the global outputs
            for o in self.outputs:
                if o.name in data:
                    data[o.name] = walk.output(o.name, data[o.name])
        if record:
            for variable in self.inputs:
                variable.data = input_tensors.get(variable.name, variable.data)
        return data

    # ------------------------------------------------------------------
    # Sharded execution (parallel/): one rank's walk
    # ------------------------------------------------------------------

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _sharded_walk(self):
        if not self._sharded():
            return None
        from .parallel.walk import ShardedWalk
        return ShardedWalk(self)

    def _local_params(self) -> dict:
        """{constant name: this rank's piece} of every constant the
        sharding rules split (built once, on the mesh's device); a
        constant built on another device is moved there whole."""
        if self._shards is None:
            from .parallel.sharding import param_shardings
            shards = param_shardings(self, self.mesh, self._shard_rules)
            specs = {n: spec for n, (spec, _) in shards.items()}
            local = {n: t for n, (_, t) in shards.items()}
            dev = self.mesh.device
            for v in self.values:
                if isinstance(v, Constant) and v.name not in local \
                        and isinstance(v.data, (FTensor, QTensor,
                                                PackedQTensor)) \
                        and v.data.data.device != dev:
                    local[v.name] = _moved(self._wrap_constant(v), dev)
            self._shards = (specs, local)
        return self._shards[1]

    def _local_specs(self) -> dict:
        self._local_params()
        return self._shards[0]

    def _local_constant(self, value: Constant) -> Tensor:
        t = self._local_params().get(value.name)
        if t is None:
            return self._wrap_constant(value)
        if isinstance(t, FTensor):
            out = FTensor(t.data)  # the current float dtype
            if getattr(t, "host", None) is not None:
                out.host = t.host
            return out
        return t

    def _finalize_output(self, tensor: Tensor):
        data = tensor.data
        if isinstance(data, torch.Tensor) and data.dtype == torch.bfloat16:
            return data.to(torch.float32)
        return data

    # ------------------------------------------------------------------
    # Control flow (ONNX If / Loop)
    # ------------------------------------------------------------------
    # Folded while the walk runs, JAX's trace-time design: the If
    # condition and the Loop trip count and condition must be host
    # ITensors (shape math), so the branch taken and the iterations run
    # are fixed by the host walk -- the captured forward replays that
    # walk. A device-resident condition raises; nothing is read back from
    # the device. Bodies run through the same registry; enclosing QTensors
    # dequantize at the boundary (body compute is float).

    def _run_node(self, node: Node, ins: list, env) -> list:
        if node.op in ("If", "Loop"):
            return self._exec_subgraph_op(node, ins, env)
        return onnx_operator_implementation(node.op, ins, node.attrs)

    def _body(self, gproto):
        """A body graph, imported once (its constants placed outside any
        capture)."""
        key = id(gproto)
        if key not in self._subgraphs:
            # the proto is kept beside its import: its id stays unique
            self._subgraphs[key] = (gproto, import_graph(gproto, self.device))
        return self._subgraphs[key][1]

    def _run_subgraph(self, gproto, outer, input_tensors: list) -> list:
        nodes, values, g_inputs, g_outputs = self._body(gproto)
        data: dict[str, Tensor] = {}
        for value in values:
            if isinstance(value, Constant):
                data[value.name] = Model._wrap_constant(self, value)
        for var, t in zip(g_inputs, input_tensors):
            data[var.name] = t

        def get(name):
            if name in data:
                return data[name]
            t = outer[name]  # enclosing-scope capture by name
            if isinstance(t, QTensor):
                t = t.dequantize()
            data[name] = t
            return t

        for node in nodes:
            ins = [None if v is None else get(v.name) for v in node.inputs]
            outs = self._run_node(node, ins, _ScopeChain(data, outer))
            for o, t in zip(node.outputs, outs):
                data[o.name] = t
        return [get(v.name) for v in g_outputs]

    def _exec_subgraph_op(self, node: Node, ins: list, env) -> list:
        if node.op == "If":
            cond = ins[0]
            if not isinstance(cond, ITensor):
                raise ValueError(
                    "If condition must be host-resident (shape-domain) so "
                    "the branch folds on the host; a data-dependent "
                    "condition cannot select a branch of one captured "
                    "forward")
            taken = bool(np.asarray(cond.data).reshape(()))
            branch = node.attrs["then_branch" if taken else "else_branch"]
            return self._run_subgraph(branch, env, [])

        # Loop(M, cond, v_1..v_N) -> (v_1..v_N, scan_1..scan_K); body:
        # (iter, cond_in, v...) -> (cond_out, v..., scan...)
        body = node.attrs["body"]
        m = ins[0] if len(ins) > 0 else None
        cond = ins[1] if len(ins) > 1 else None
        carried = list(ins[2:])
        n_carried = len(carried)
        n_scan = len(node.outputs) - n_carried
        for t, what in ((m, "trip count"), (cond, "initial condition")):
            if t is not None and not isinstance(t, ITensor):
                raise ValueError(
                    f"Loop {what} must be host-resident so the loop "
                    "unrolls on the host (static shapes)")
        cap = 10_000
        max_iters = cap if m is None else int(np.asarray(m.data).reshape(()))
        cond_val = True if cond is None \
            else bool(np.asarray(cond.data).reshape(()))
        scans = [[] for _ in range(n_scan)]
        it = 0
        while cond_val and it < max_iters:
            outs = self._run_subgraph(
                body, env,
                [ITensor(np.array(it, np.int64)),
                 ITensor(np.array(int(cond_val), np.int64))] + carried)
            cond_out = outs[0]
            carried = list(outs[1:1 + n_carried])
            for buf, t in zip(scans, outs[1 + n_carried:]):
                buf.append(t)
            if not isinstance(cond_out, ITensor):
                raise ValueError(
                    "data-dependent Loop termination is not supported: the "
                    "body's cond output must stay host-resident so the "
                    "unrolled walk has a static iteration count")
            cond_val = bool(np.asarray(cond_out.data).reshape(()))
            it += 1
        if m is None and cond_val and it >= cap:
            raise ValueError(f"Loop exceeded {cap} host iterations")
        if n_scan and it == 0:
            raise ValueError("Loop with scan outputs ran zero iterations; "
                             "the scan shape is undefined")
        stacked = []
        for buf in scans:
            if all(isinstance(t, ITensor) for t in buf):
                stacked.append(ITensor(np.stack([t.data for t in buf], 0)))
            else:
                stacked.append(FTensor(torch.stack([t.data for t in buf], 0)))
        return carried + stacked

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def __call__(self, inputs: list, profile: bool = False,
                 record: bool = False, as_numpy: bool = True,
                 inplace: tuple = ()):
        """Run the model on numpy arrays or tensors.

        On CUDA a call replays the captured graph of its input signature
        (``graph_key``), capturing it on the signature's first call: one
        eager walk on a side stream (kernels built, weights placed), the
        capture, then the replay. A walk that cannot be captured raises,
        naming the node. A replay copies the inputs into the graph's input
        buffers and returns fresh output tensors. ``inplace``: positions
        of CUDA tensor inputs the graph reads where they lie, e.g. KV
        caches the caller writes between calls: the capture takes these
        tensors as its own input buffers, so a call that passes them again
        copies nothing; passing other tensors there captures anew, in the
        old graph's place.

        ``profile=True`` walks eagerly, the device synchronized around
        each node, and returns (outputs, {op type: seconds}) as the JAX
        package does; ``record=True`` walks eagerly and also stores every
        value's tensor in ``value.data``; under ``config.eager_forward``,
        and on the CPU, every call walks eagerly. ``as_numpy=False``
        returns the outputs as device tensors."""
        if profile or record or config.eager \
                or self.device.type != "cuda" or self._sharded():
            # a sharded walk's collectives cannot sit in a captured graph
            input_tensors = {v.name: self._wrap_input(a, v)
                             for a, v in zip(inputs, self.inputs)}
            timings = self._profile_buckets() if profile else None
            data = self._forward(input_tensors, record=record,
                                 timings=timings)
            outs = [self._finalize_output(data[o.name])
                    for o in self.outputs]
        else:
            outs = self._replay(list(inputs), tuple(inplace))
        if as_numpy:
            outs = [o.cpu().numpy() if isinstance(o, torch.Tensor)
                    else np.asarray(o) for o in outs]
        if profile:
            return outs, timings
        return outs

    # ------------------------------------------------------------------
    # Captured forwards (CUDA graphs)
    # ------------------------------------------------------------------

    def _bound_fn(self, ints: dict):
        """The walk as ``fn(float_inputs) -> outputs`` with the int64
        inputs ``ints`` ({position: ITensor}) bound; holds the model
        weakly, so a cached graph does not keep it alive."""
        model = weakref.proxy(self)

        def fn(float_inputs: list) -> list:
            fa = iter(float_inputs)
            input_tensors = {
                v.name: ints[i] if i in ints
                else model._wrap_input(next(fa), v)
                for i, v in enumerate(model.inputs)}
            data = model._forward(input_tensors)
            return [model._finalize_output(data[o.name])
                    for o in model.outputs]

        return fn

    def lowered_fn(self):
        """The model as a pure function ``fn(float_inputs: list) -> list``
        of output tensors (the walk a capture records; float inputs only,
        int64 shape inputs are bound through ``__call__``)."""
        return self._bound_fn({})

    def _captured(self, arrays: list, inplace: tuple = ()) -> tuple:
        """(entry, fresh): the captured forward of ``arrays``' signature,
        captured now (``fresh``) if there is none or its bound inputs
        moved."""
        key = graph_key(arrays, self.device)
        entry = self._graphs.get(key)
        if entry is not None and entry.bound == _bound(arrays, inplace):
            return entry, False
        # a replaced graph goes first: its pool blocks serve the new one
        self._graphs.pop(key, None)
        entry = self._capture(arrays, inplace)
        self._graphs[key] = entry
        return entry, True

    def _replay(self, arrays: list, inplace: tuple) -> list:
        entry, fresh = self._captured(arrays, inplace)
        if not fresh:
            for i, buf in entry.inputs.items():
                a = arrays[i]
                if a is not buf and i not in inplace:
                    buf.copy_(a if isinstance(a, torch.Tensor)
                              else torch.from_numpy(np.asarray(a)))
        entry.graph.replay()
        _kernels.add_launch_counts(entry.launches)
        return [o.clone() if isinstance(o, torch.Tensor) else np.array(o)
                for o in entry.outputs]

    def _capture(self, arrays: list, inplace: tuple) -> _Captured:
        """Capture the walk over ``arrays``' signature. The warm-up walk
        and the capture leave the launch counters as they were; the
        returned entry's ``launches`` are what each replay adds."""
        start = perf_counter()
        ints, static = {}, {}
        for i, a in enumerate(arrays):
            if _is_shape_input(a):
                ints[i] = ITensor(a.copy())
            elif i in inplace:
                if not (isinstance(a, torch.Tensor)
                        and a.device.type == self.device.type):
                    raise ValueError(f"input {i} is read in place: it must "
                                     f"be a tensor on {self.device}")
                static[i] = a
            else:
                t = self._device_tensor(a)
                static[i] = torch.empty(t.shape, dtype=t.dtype,
                                        device=self.device).copy_(t)
        fn = self._bound_fn(ints)
        floats = [static[i] for i in sorted(static)]
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()

        def failed(exc):
            if self._failed is None:
                return RuntimeError(f"the forward cannot be captured: {exc}")
            node, first = self._failed
            return RuntimeError(
                f"the forward cannot be captured at node {node.name!r} "
                f"({node.op}): {first}")

        self._failed = None
        graph, outputs, launches = capture_walk(fn, floats, self.device,
                                                self._graph_pool, failed)
        return _Captured(graph, static, outputs, launches,
                         _bound(arrays, inplace), perf_counter() - start)

    def invalidate_graphs(self) -> None:
        """Drop every captured forward: a weight, the graph or its
        quantization changed, and a replay would read what is gone. The
        sharded constants go with them."""
        self._graphs.clear()
        self._shards = None

    def invalidate_params(self) -> None:
        """A constant changed: drop what was built from the old values (on
        a float model, the captured forwards)."""
        self.invalidate_graphs()

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
        shapes = {}

        def visit(name, tensor):
            shapes[name] = tuple(int(s) for s in tensor.data.shape)

        mesh, self.mesh = self.mesh, None  # global shapes: walk unsharded
        try:
            with torch.inference_mode():
                self._forward(input_tensors, visit=visit)
        finally:
            self.mesh = mesh
        return shapes

    # ------------------------------------------------------------------
    # Calibration + PTQ pass
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def calibration_stats(self, inputs: list, mode: str = "auto",
                          percentile: float = None) -> dict:
        """Global min/max per value name (constants included). Each value
        folds to its (min, max) as it is made, so the walk frees it after
        its last use; the device extremes cross to the host once, at the
        end.

        ``mode``: "jit" captures the walk with every reduction into one
        CUDA graph and replays it (the counterpart of JAX's one jitted
        program; on the CPU the walk runs eagerly); "eager" walks node by
        node; "auto" takes "jit" below 150 nodes, else "eager", as the JAX
        package does. All three give the same stats bit for bit.

        ``percentile``: clip ACTIVATION ranges to the [100 - p, p]
        percentiles (e.g. 99.99), JAX's ``jnp.quantile`` with linear
        interpolation at float32 quantiles (:func:`percentile_range`).
        Constants keep their exact min/max."""
        if mode == "auto":
            mode = "jit" if len(self.nodes) < 150 else "eager"
        if mode not in ("jit", "eager"):
            raise ValueError(f"mode {mode!r} not in (auto, jit, eager)")
        const_names = {v.name for v in self.values if isinstance(v, Constant)}
        if percentile is not None and not 50.0 < percentile <= 100.0:
            raise ValueError(f"percentile {percentile} not in (50, 100]")
        host: dict = {}
        names: list = []  # the device-reduced values, in the walk's order
        order: list = []  # every value, in the walk's order

        def fold(floats: list) -> torch.Tensor:
            host.clear()
            names.clear()
            order.clear()
            rows = []
            fa = iter(floats)
            input_tensors = {
                v.name: ITensor(a) if _is_shape_input(a)
                else self._wrap_input(next(fa), v)
                for a, v in zip(inputs, self.inputs)}

            def visit(name, tensor):
                order.append(name)
                if isinstance(tensor, ITensor):
                    host[name] = (np.float32(tensor.data.min()),
                                  np.float32(tensor.data.max()))
                    return
                d = tensor.data.to(torch.float32)
                if percentile is not None and name not in const_names:
                    rows.append(percentile_range(d, percentile))
                else:
                    rows.append(torch.stack([d.min(), d.max()]))
                names.append(name)

            self._forward(input_tensors, visit=visit)
            return torch.stack(rows) if rows else torch.zeros((0, 2))

        floats = [a for a in inputs if not _is_shape_input(a)]
        if percentile is not None and self._sharded():
            raise ValueError("percentile calibration under a mesh: run "
                             "calibration_stats on the unsharded model")
        if mode == "jit" and self.device.type == "cuda" \
                and not self._sharded():
            floats = [self._device_tensor(a) for a in floats]
            stream = _warm_up(fold, floats, self.device)
            graph, extremes = _capture_graph(
                fold, floats, stream, torch.cuda.graph_pool_handle())
            graph.replay()
            extremes = extremes.cpu().numpy()
            del graph
        else:
            extremes = fold(floats)
            if self._sharded():
                # min and max are associative: the shards' extremes reduce
                # to the single-process stats exactly
                from .parallel.mesh import all_reduce
                extremes = torch.stack(
                    [all_reduce(extremes[:, 0], self.mesh, None, "min"),
                     all_reduce(extremes[:, 1], self.mesh, None, "max")], 1)
            extremes = extremes.cpu().numpy()
        device = {name: (np.float32(mn), np.float32(mx))
                  for name, (mn, mx) in zip(names, extremes)}
        return {name: host[name] if name in host else device[name]
                for name in order}

    @torch.inference_mode()
    def quantize(self, calibration_inputs: list = None, bit_width: int = 8,
                 stats: dict = None, quantize_conv: bool = False,
                 per_channel_weights: bool = False,
                 weight_bit_width=None, calibration_mode: str = "auto",
                 percentile: float = None) -> "QModel":
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
        unlisted weights keep ``bit_width``.
        ``calibration_mode``, ``percentile``: how ``calibration_inputs``
        calibrate (``calibration_stats``' ``mode`` and ``percentile``).

        Widths run from 1 to 16 bits. Up to 8 bits the QModel computes in
        the JAX package's TPU-mode numerics (int32 containers); if any
        width exceeds 8, in its x64 mode (int64 containers, exact int64
        accumulators, 4x-width biases up to 64 bits)."""
        wbw_map = weight_bit_width if isinstance(weight_bit_width, dict) \
            else None
        wbw = weight_bit_width if isinstance(weight_bit_width, int) \
            else bit_width
        widths = [bit_width, wbw, *(wbw_map or {}).values()]
        if min(widths) < 1 or max(widths) > 16:
            raise ValueError(f"bit widths run from 1 to 16, got "
                             f"{min(widths)}..{max(widths)}")
        container = container_dtype(max(widths))
        if stats is None:
            stats = self.calibration_stats(calibration_inputs,
                                           mode=calibration_mode,
                                           percentile=percentile)
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

        def is_shape_domain_const(value) -> bool:
            """A float constant read only as a secondary input of
            Resize/Pad (scales, roi, pad value) is graph structure, not
            data: it stays float."""
            return bool(value.outputs) and all(
                n.op in ("Resize", "Pad") and value is not n.inputs[0]
                for n in value.outputs)

        # constants: symmetric, per-tensor or (2-D weights) per-channel
        for value in self.values:
            if isinstance(value, Constant):
                if isinstance(value.data, ITensor) \
                        or is_shape_domain_const(value):
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
                                    qp.zero_point, container))
                qparams_per_value[value.name] = qp

        def quantize_bias(bias, bias_scale):
            qparams_per_value[bias.name] = QuantizationParams(bias_scale, None)
            qbias = quantize_tensor(value_dict[bias.name].data,
                                    4 * bit_width, bias_scale, None,
                                    container)
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
                      quantized_ops=quantized_ops, device=self.device,
                      container=container)

    # ------------------------------------------------------------------
    # PTQ accuracy passes on the float model (run before quantize)
    # ------------------------------------------------------------------

    def smooth_outliers(self, inputs: list, alpha: float = 0.5) -> int:
        """SmoothQuant-style activation-outlier migration: an exact
        reparameterization dividing each norm's output by per-channel
        factors (folded into gamma/beta) that the consuming MatMul/Gemm
        weights multiply back. Returns the number of smoothed groups. See
        smoothquant.py."""
        from .smoothquant import smooth_outliers
        return smooth_outliers(self, inputs, alpha=alpha)

    def rotate_vo(self, seed: int = 0) -> int:
        """QuaRot-style orthogonal rotation of every attention's V/O
        projection pair (exact, data-free). Returns the number of
        attentions rotated. See rotate.py."""
        from .rotate import rotate_vo
        return rotate_vo(self, seed=seed)

    def awq_scale_weights(self, inputs: list, bit_width: int = 4,
                          group_size: int = None, n_grid: int = 20,
                          **kw) -> dict:
        """AWQ-style activation-aware weight scaling: the smooth_outliers
        reparameterization with the exponent grid-searched per group on
        the weight-only reconstruction error. Give the bit width and
        grouping of the quantize_weights call that follows. Returns {norm
        node name: best alpha}. See awq.py."""
        from .awq import awq_scale_weights
        return awq_scale_weights(self, inputs, bit_width=bit_width,
                                 group_size=group_size, n_grid=n_grid, **kw)

    def equalize(self, iterations: int = 2) -> int:
        """Cross-layer equalization over ReLU/MaxPool-linked constant-
        weight pairs (exact, data-free). Returns the pairs equalized per
        sweep. See equalize.py."""
        from .equalize import equalize
        return equalize(self, iterations=iterations)

    def fold_batchnorm(self) -> int:
        """Fold inference-mode BatchNormalization nodes into the preceding
        constant-weight Conv/Gemm (W' = W*k, b' = b*k + shift, k =
        gamma/sqrt(var+eps)): an exact float reparameterization, run
        before ``quantize``. Returns the number folded. See bnfold.py."""
        from .bnfold import fold_batchnorm
        return fold_batchnorm(self)

    def quantize_dynamic(self, bit_width: int = 8, **kw):
        """Dynamic quantization: integer matmuls whose activation scales
        come from each batch, no calibration data. See
        dynamic.quantize_dynamic for the options (granularity,
        weight_bit_width, per_channel_weights)."""
        from .dynamic import quantize_dynamic
        return quantize_dynamic(self, bit_width=bit_width, **kw)

    def map_batches(self, inputs: List[np.ndarray], as_numpy: bool = True):
        """Throughput inference over a leading STEPS axis: every step
        enqueued on the device, one host sync at the end. See
        serving.py."""
        from .serving import map_batches
        return map_batches(self, inputs, as_numpy=as_numpy)

    def serve_stream(self, batches, depth: int = 2, as_numpy: bool = True):
        """Pipelined online request-stream inference: a generator keeping
        up to ``depth`` forwards in flight. See serving.py."""
        from .serving import serve_stream
        return serve_stream(self, batches, depth=depth, as_numpy=as_numpy)

    def serve_ring(self, batches, probe: bool = True) -> list:
        """Serve a live feed of batches in one session the device paces:
        on CUDA each batch replays the signature's captured forward, fed
        from a ring of pinned host buffers. See serving.py."""
        from .serving import serve_ring
        return serve_ring(self, batches, probe=probe)

    def fuse_decode_attention(self) -> int:
        """Fuse KV-cache decode-step attention chains ([B, 1, H] query,
        scores over [cache | current], slice/context) into single
        DecodeAttention nodes: float dots with the cache dequantize fused
        into the operands, no per-step zero-point correction sums over the
        whole cache. Works on float models and QModels (ulp-equal there:
        the dots run in float). Returns the number fused. See
        passes/decode_attention.py."""
        from .passes import fuse_decode_attention
        return fuse_decode_attention(self)

    def qat_quantize(self, inputs: list, **kw) -> "QModel":
        """Quantization-aware training: fine-tune the weights end to end
        under fake quantization (straight-through gradients through the
        whole forward, torch autograd and Adam), then quantize with the
        same frozen calibration params. See qat.qat_quantize for the knobs;
        quantize() kwargs (bit_width, weight_bit_width, ...) pass through.
        The float model is left untouched."""
        from .qat import qat_quantize
        return qat_quantize(self, inputs, **kw)

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
        self.invalidate_graphs()
        return converted


class QModel(Model):
    """Quantized executor. ``container``: the integer dtype its quantize
    boundaries write, int32 (TPU-mode numerics) or int64 (x64 mode, any
    width above 8 bits); by default that of ``bit_width``."""

    def __init__(self, nodes, values, inputs, outputs, bit_width: int,
                 quant_params: dict[str, QuantizationParams],
                 quantized_ops: tuple = ("MatMul", "Gemm"),
                 device: torch.device = None, container: torch.dtype = None):
        super().__init__(nodes, values, inputs, outputs, device)
        self.bit_width = bit_width
        self.container = container or container_dtype(bit_width)
        self.quant_params = quant_params
        self.quantized_ops = tuple(quantized_ops)
        # ops whose outputs requantize to the model bit width
        self.requantized_ops = tuple(op for op in self.quantized_ops
                                     if op in ("Gemm", "Conv"))
        # values planned for early quantization (int8_dataflow pass)
        self._int8_values: set = set()
        self._dp_cache = None
        # pipeline stages (parallel/pipeline.py): an interior stage takes
        # and hands on the float boundary activation as it is
        self._passthrough_wrap = False
        self._passthrough_finalize = False
        # merge_parallel_matmuls in optimize(): None follows the mesh
        self._opt_merge_matmuls = None

    def _device_params(self) -> dict[str, torch.Tensor]:
        """Constant payloads as executed: int8 storage for <= 8-bit
        QTensors (the JAX package's TPU-mode layout, identical values;
        wider payloads keep their int64 containers),
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
        """Drop the placed payloads (a payload changed) and with them every
        captured forward."""
        self._dp_cache = None
        self.invalidate_graphs()

    # ------------------------------------------------------------------
    # PTQ accuracy passes on the quantized payloads (before pack_weights)
    # ------------------------------------------------------------------

    def correct_biases(self, float_model: Model, inputs: list,
                       passes: int = 1) -> int:
        """Empirical bias correction: subtract each quantized layer's mean
        output error over the calibration batch from its bias. Returns
        the number of corrected biases. See bias_correction.py."""
        from .bias_correction import correct_biases_qmodel
        return correct_biases_qmodel(self, float_model, inputs,
                                     passes=passes)

    def adaround(self, float_model: Model, inputs: list, **kw) -> int:
        """AdaRound: learn each weight element's rounding direction by
        minimizing its layer's output reconstruction error on calibration
        data. Mutates the MatMul/Gemm payloads; call before
        pack_weights(). Returns the number of tuned weights. See
        adaround.py."""
        from .adaround import adaround_qmodel
        return adaround_qmodel(self, float_model, inputs, **kw)

    def gptq(self, float_model: Model, inputs: list, **kw) -> int:
        """GPTQ: requantize weights row by row along the contraction axis,
        absorbing each row's error into the rest through the inverse
        Hessian of the layer reconstruction loss. Mutates the MatMul/Gemm
        payloads; call before pack_weights(). Returns the number of
        requantized weights. See gptq.py."""
        from .gptq import gptq_qmodel
        return gptq_qmodel(self, float_model, inputs, **kw)

    def _profile_buckets(self) -> dict[str, float]:
        buckets = super()._profile_buckets()
        buckets["TinyqQuant"] = 0.0
        buckets["TinyqDequant"] = 0.0
        return buckets

    def _timed(self, timings, bucket: str, fn):
        """``fn()``; under profile mode its wall time, the device
        synchronized around it, goes to ``timings[bucket]``."""
        if timings is None:
            return fn()
        self._sync()
        start = perf_counter()
        out = fn()
        self._sync()
        timings[bucket] += perf_counter() - start
        return out

    def _weight_colsum(self, value: Constant):
        """Column sums of a 2-D quantized weight consumed only as MatMul
        rhs: the q_matmul correction reduces them once, not per
        forward (identical integers)."""
        data = value.data.data
        if data.ndim != 2 or not only_rhs_of(value,
                                             ("MatMul", "MatMulSplit")):
            return None
        idt = torch.int64 if data.dtype == torch.int64 else torch.int32
        return data.to(idt).sum(dim=0, keepdim=True, dtype=idt)

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
        if self._passthrough_wrap and t.is_floating_point():
            return FTensor(t)  # a stage boundary: the float carry as is
        qp = self.quant_params[variable.name]
        if t.dtype == torch.float32:
            return quantize_tensor(FTensor(t), self.bit_width, qp.scale,
                                   qp.zero_point, self.container)
        if t.dtype == torch.int8:
            # pre-quantized with this input's calibrated params
            return QTensor(t, self.bit_width, qp.scale, qp.zero_point)
        if t.dtype == torch.int64:
            return DITensor(t)  # device token ids: keyed by shape, not value
        raise ValueError(f"Array dtype {t.dtype} not supported")

    def _node_inputs(self, node: Node, data: dict[str, Tensor],
                     timings=None) -> list[Tensor]:
        ins = []
        if node.op == "DecodeAttention":
            # raw tensors: the op replays the unfused chain's quantize and
            # dequantize itself (ops/registry.py), so int8 caches stream in
            # untouched
            return [None if v is None else data[v.name] for v in node.inputs]
        if node.op in self.quantized_ops:
            # quantize float inputs on the fly ("TinyqQuant")
            for idx, v in enumerate(node.inputs):
                if v is None:
                    ins.append(None)
                    continue
                t = data[v.name]
                if isinstance(t, FTensor):
                    qp = self.quant_params[v.name]
                    t = self._timed(timings, "TinyqQuant",
                                    lambda t=t, qp=qp: quantize_tensor(
                                        t, self.bit_width, qp.scale,
                                        qp.zero_point, self.container))
                elif (isinstance(t, QTensor)
                      and t.bit_width != self.bit_width
                      and (idx < 2 or (idx == 2 and node.op in (
                          "FusedAttention", "FusedAttentionHS")))):
                    # a 4x-width accumulator OPERAND (never a bias)
                    # narrows with this value's calibrated params
                    t = self._narrow(t, v, node)
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
                    t = self._timed(timings, "TinyqDequant", t.dequantize)
                ins.append(t)
        return ins

    def _narrow(self, t: QTensor, value: Value, consumer: Node) -> QTensor:
        """An accumulator operand ``value`` of ``consumer`` at the model bit
        width, as the unfused graph handed it over: a FusedAttentionHS
        stands where the head-split Reshape dequantized the accumulator and
        the score or context MatMul quantized the floats (x / scale); any
        other quantized op takes the accumulator itself and requantizes it
        (x * (1 / scale), the reference's requantize). The two round a value
        near a rounding boundary apart, and the fused node must equal the
        chain it replaced."""
        qp = self.quant_params[value.name]
        if consumer.op == "FusedAttentionHS":
            return quantize_tensor(t.dequantize(), self.bit_width, qp.scale,
                                   qp.zero_point, self.container)
        return t.requantize(self.bit_width, qp.scale, qp.zero_point)

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
                                            qp.zero_point, self.container)
                    elif isinstance(t, QTensor) \
                            and t.bit_width != self.bit_width:
                        t = t.requantize(self.bit_width, qp.scale,
                                         qp.zero_point)
                outs.append(t)
            return outs
        return outputs

    def _finalize_output(self, tensor: Tensor):
        if self._passthrough_finalize and isinstance(tensor, FTensor):
            return tensor.data  # handed to the next stage as it flows
        if isinstance(tensor, QTensor):
            # dequantizes to the float dtype, bf16 in the serving mode
            tensor = tensor.dequantize()
        if isinstance(tensor, FTensor):
            data = tensor.data
            return data.to(torch.float32) if data.dtype == torch.bfloat16 \
                else data
        if isinstance(tensor, DITensor):
            return tensor.data
        raise ValueError(f"Unsupported output tensor {type(tensor)}")

    def fuse_attention(self) -> int:
        """Fuse MatMul -> scale -> Softmax -> MatMul chains with their
        head split/merge into FusedAttentionHS nodes, or (where the split
        does not match) the core alone into FusedAttention nodes. See
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

    def merge_parallel_matmuls(self) -> int:
        """Merge the MatMuls that share one activation (the Q/K/V
        projections) into one MatMulSplit over the concatenated weights.
        See passes/matmul_merge.py."""
        from .passes.matmul_merge import merge_parallel_matmuls
        return merge_parallel_matmuls(self)

    def optimize(self, verbose: bool = False) -> dict:
        """Apply the graph passes that keep the executor's numerics:
        attention fusion, GELU fusion, dead-token elimination and early
        int8 quantization; decode-step graphs fuse their KV-cache attention
        into DecodeAttention (ulp-equal: float dots). Returns a {pass:
        count} summary plus the Softmaxes that did not fuse (node name,
        reason)."""
        fused = self.fuse_attention()
        # the [B, 1, H] KV-cache chain, which fuse_attention's
        # full-sequence patterns reject
        dec = self.fuse_decode_attention()
        # merged Q/K/V products: the JAX package's gate (on by itself
        # under a tensor-parallel mesh; ``_opt_merge_matmuls`` True/False
        # forces either way)
        from .parallel.sharding import model_axis_size
        flag = self._opt_merge_matmuls
        do_merge = flag if flag is not None else model_axis_size(self) >= 2
        merged = self.merge_parallel_matmuls() if do_merge else 0
        gelu = self.fuse_gelu()
        narrowed = self.narrow_gather()
        planned = self.int8_dataflow()
        failures = list(self.fusion_report["failures"])
        if verbose:
            for name, reason in failures:
                print(f"optimize: Softmax {name!r} not fused: {reason}")
        return {"fuse_attention": fused, "fuse_decode_attention": dec,
                "merge_parallel_matmuls": merged, "fuse_gelu": gelu,
                "narrow_gather": narrowed, "int8_dataflow": planned,
                "fusion_failures": failures}
