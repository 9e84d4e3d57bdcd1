"""Deployment artifacts: the traced model program saved beside its
payloads (port of ``numpy_quant_tpu/utils/aot.py``).

``save_qmodel`` (utils/serialization.py) keeps the graph and the payloads
and needs this package to serve again. An artifact keeps the other half:
the walk itself, traced by ``torch.export`` into one ATen program with the
hand kernels as the custom ops ``nqt::*`` (kernels/), saved with
``torch.export.save`` into one archive that holds

* the program: every executor decision (int8 dataflow, fused attention,
  packed matmuls, requantize epilogues) as traced on the model's device,
* the payloads it reads, as the program's buffers (lifted inputs, not
  constants folded into it): int8 storage, column sums and packed
  payloads as ``QModel._device_params`` holds them, and the float
  constants, and
* ``nqt_aot.json``: the magic ``nqt_aot_v1``, the kind (``forward`` or
  ``decode``) and the device traced for.

Loading needs torch, numpy and the registered ops (importing this package
registers them): ``load_compiled(path)`` returns a plain callable, with no
Model, graph, ONNX file or calibration state. On CUDA it replays one
captured CUDA graph per input signature, as ``Model.__call__`` does.

``save_decode_loop`` exports the whole ``generate_kv`` loop (teacher-forced
prefill and generation) as one ``while_loop`` over the step
(:func:`utils.generate._kv_step`); the prompt's shape and
``max_new_tokens`` are baked in, the prompt's values and the sampling
noise are the program's inputs.

A torch program is traced from the walk on one device, and the walk
differs by device (XLA's sum order on the CPU, cuBLASLt's padding on CUDA:
``intops.int_mm_shape``), so an artifact serves the device it was traced
on only: ``devices`` (JAX's ``platforms``) may name that device alone.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import zipfile

import numpy as np
import torch
from torch._higher_order_ops.while_loop import while_loop_op
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves, tree_map_only

from .. import kernels as _kernels  # registers the nqt:: custom ops
from ..graph import Constant
from ..model import QModel, _is_shape_input, capture_walk
from ..tensor import FTensor, ITensor, PackedQTensor, QTensor

MAGIC = "nqt_aot_v1"
JAX_MAGIC = "nq_aot_v1"  # numpy_quant_tpu/utils/aot.py's .npz artifacts
_META = "nqt_aot.json"

__all__ = ["load_compiled", "load_decode_loop", "save_compiled",
           "save_decode_loop"]


# -- the payloads a walk reads ----------------------------------------------

def _payloads(model) -> dict:
    """{name: tensor} of every payload ``model``'s walk reads, as it reads
    them: a QModel's ``_device_params`` (int8 storage, column sums, packed
    planes and their column sums) and every float constant. Packed
    payloads of a float model (weight-only) are read where they lie."""
    dp = model._device_params() if isinstance(model, QModel) else {}
    out = {}
    for value in model.values:
        if not isinstance(value, Constant):
            continue
        data = value.data
        if isinstance(data, PackedQTensor):
            packed = dp.get(value.name, data)
            out[value.name + ".planes"] = packed.planes
            out[value.name + ".colsum"] = packed.colsum
        elif isinstance(data, QTensor) and value.name in dp:
            out[value.name] = dp[value.name]
            if value.name + ".colsum" in dp:
                out[value.name + ".colsum"] = dp[value.name + ".colsum"]
        elif isinstance(data, FTensor):
            out[value.name] = data.data
    return out


def _packed_like(src: PackedQTensor, planes, colsum) -> PackedQTensor:
    p = PackedQTensor(planes, colsum, src.k, src.n, src.bit_width, src.scale,
                      src.layout)
    p._scale_vec = src._scale_vec  # placed by the warm-up walk
    return p


@contextlib.contextmanager
def _reading(model, tensors: dict):
    """``model``'s walk reading ``tensors`` (:func:`_payloads`' names) in
    place of its payloads, e.g. the buffers of a module being exported."""
    is_q = isinstance(model, QModel)
    dp = model._device_params() if is_q else {}
    swapped, new_dp = [], dict(dp)
    for value in model.values:
        if not isinstance(value, Constant):
            continue
        data = value.data
        if isinstance(data, PackedQTensor):
            p = _packed_like(dp.get(value.name, data),
                             tensors[value.name + ".planes"],
                             tensors[value.name + ".colsum"])
            if value.name in dp:
                new_dp[value.name] = p
            else:
                swapped.append((value, data))
                value.data = p
        elif isinstance(data, QTensor) and value.name in dp:
            new_dp[value.name] = tensors[value.name]
            if value.name + ".colsum" in dp:
                new_dp[value.name + ".colsum"] = tensors[value.name
                                                         + ".colsum"]
        elif isinstance(data, FTensor):
            f = FTensor(tensors[value.name])
            if getattr(data, "host", None) is not None:
                f.host = data.host
            swapped.append((value, data))
            value.data = f
    if is_q:
        model._dp_cache = new_dp
    try:
        yield
    finally:
        for value, data in swapped:
            value.data = data
        if is_q:
            model._dp_cache = dp


class _Program(torch.nn.Module):
    """``body(payloads, tables, *args)`` over the model's payloads
    (:func:`_payloads`) and the ``tables`` given (a decode loop's
    embedding, RoPE, bias and mask tables), each a {name: tensor} of
    buffers, so that ``torch.export`` lifts them as the program's
    inputs."""

    def __init__(self, model, body, tables: dict = None):
        super().__init__()
        self._body = body
        payloads = _payloads(model)
        self._names = list(payloads)
        for i, t in enumerate(payloads.values()):
            self.register_buffer(f"p{i:05d}", t)
        self._tables = [k for k, t in (tables or {}).items() if t is not None]
        for k in self._tables:
            self.register_buffer(f"table_{k}", tables[k])

    def forward(self, *args):
        payloads = {name: getattr(self, f"p{i:05d}")
                    for i, name in enumerate(self._names)}
        tables = {k: getattr(self, f"table_{k}") for k in self._tables}
        return self._body(payloads, tables, *args)


# -- devices and the artifact's metadata -----------------------------------

def _traced_device(model, devices) -> torch.device:
    dev = torch.device(model.device)
    if devices is None:
        return dev
    names = [torch.device(d) for d in (
        (devices,) if isinstance(devices, (str, torch.device)) else devices)]
    if any(d.type != dev.type for d in names) or not names:
        raise ValueError(
            f"devices={tuple(str(d) for d in names)}: an artifact serves "
            f"only the device its walk was traced on ({dev}); the walk "
            "differs by device (the CPU's XLA sum order, CUDA's cuBLASLt "
            "padding), so trace a model placed on each device")
    return dev


def _export(program, args: tuple, path: str, meta: dict) -> dict:
    """Trace ``program`` at ``args`` and save it to ``path``; returns the
    seconds of each step and the artifact's bytes."""
    t0 = time.perf_counter()
    # traced outside inference mode (the walk's placed tensors, made under
    # it, are read as they are); no_grad keeps intops.place from handing
    # out autograd copies
    with torch.no_grad():
        ep = torch.export.export(program, args, strict=False)
    t1 = time.perf_counter()
    torch.export.save(ep, path, extra_files={
        _META: json.dumps(dict(meta, magic=MAGIC))})
    return {"export_seconds": t1 - t0,
            "save_seconds": time.perf_counter() - t1,
            "bytes": os.path.getsize(path),
            "payload_bytes": sum(t.nbytes for t in
                                 program.state_dict().values())}


def _read_meta(path: str, kind: str) -> dict:
    """The artifact's metadata; ValueError for anything but a port
    artifact of ``kind``."""
    try:
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
            if "__magic__.npy" in names:
                with z.open("__magic__.npy") as f:
                    magic = str(np.lib.format.read_array(f))
                if magic.startswith(JAX_MAGIC):
                    raise ValueError(
                        f"{path} is a JAX artifact ({magic}: "
                        "numpy_quant_tpu.utils.aot, a StableHLO program); "
                        f"this loader reads {MAGIC} archives")
            meta = [n for n in names if n.endswith("/extra/" + _META)
                    or n == "extra/" + _META]
            if not meta:
                raise ValueError(f"{path} is not a {MAGIC} artifact")
            meta = json.loads(z.read(meta[0]))
    except (zipfile.BadZipFile, json.JSONDecodeError) as exc:
        raise ValueError(f"{path} is not a {MAGIC} artifact: {exc}") from exc
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{path} is not a {MAGIC} artifact")
    if meta.get("kind") != kind:
        other = {"forward": "save_compiled / load_compiled",
                 "decode": "save_decode_loop / load_decode_loop"}
        raise ValueError(f"{path} is a {meta.get('kind')} artifact "
                         f"({other.get(meta.get('kind'), '?')}), not a "
                         f"{kind} one: load it with the matching loader")
    return meta


def _serving_device(meta: dict, device) -> torch.device:
    dev = torch.device(meta["device"])
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"the artifact was traced for {dev}; it cannot "
                         f"serve {torch.device(device)}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the artifact was traced for CUDA and no "
                               "CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Replayed:
    """``module(*tensors)`` on ``device``: eagerly on the CPU; on CUDA one
    captured CUDA graph per input signature (model.py::capture_walk), the
    inputs copied into its buffers and the replay's launches added to the
    kernels' counters, as ``Model._replay`` does."""

    def __init__(self, module, device: torch.device):
        self.module = module
        self.device = device
        self.graphs: dict = {}
        self.pool = None
        self.replays = 0

    def _run(self, tensors: list) -> list:
        out = self.module(*tensors)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    @torch.inference_mode()
    def __call__(self, tensors: list) -> list:
        if self.device.type != "cuda":
            return self._run(tensors)
        key = tuple((t.dtype, tuple(t.shape)) for t in tensors)
        entry = self.graphs.get(key)
        if entry is None:
            static = [torch.empty_like(t).copy_(t) for t in tensors]
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph, outputs, launches = capture_walk(self._run, static,
                                                    self.device, self.pool)
            entry = self.graphs[key] = (graph, static, outputs, launches)
        else:
            for buf, t in zip(entry[1], tensors):
                buf.copy_(t)
        graph, _, outputs, launches = entry
        graph.replay()
        self.replays += 1
        _kernels.add_launch_counts(launches)
        return [o.clone() for o in outputs]


def _load(path: str, kind: str, device):
    meta = _read_meta(path, kind)
    dev = _serving_device(meta, device)
    ep = torch.export.load(path)
    return meta, dev, _Replayed(ep.module(), dev)


# -- the forward ------------------------------------------------------------

def save_compiled(model, path: str, example_inputs: list,
                  devices=None) -> dict:
    """Export ``model``'s walk (``Model.lowered_fn``) at the example
    inputs' shapes and dtypes, and write the program with its payloads to
    ``path`` (one ``torch.export`` archive). int64 host inputs (the shape
    domain) are baked in, as a captured forward bakes them. ``devices``:
    the model's own device (the default) or nothing; any other raises
    ValueError (see the module docstring). Returns the export's and the
    save's seconds, the artifact's bytes and its payloads' bytes."""
    dev = _traced_device(model, devices)
    bound = {i: a for i, a in enumerate(example_inputs) if _is_shape_input(a)}
    floats = [_as_device(a, dev) for i, a in enumerate(example_inputs)
              if i not in bound]
    fn = model._bound_fn({i: ITensor(a.copy()) for i, a in bound.items()})
    with torch.inference_mode():
        fn(floats)  # places every host array the walk reads

    def body(payloads, tables, *inputs):
        with _reading(model, payloads):
            return tuple(fn(list(inputs)))

    return _export(_Program(model, body), tuple(floats), path, dict(
        kind="forward", device=str(dev), n_inputs=len(example_inputs),
        bound={str(i): [list(a.shape), a.tobytes().hex()]
               for i, a in bound.items()}))


def _as_device(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def load_compiled(path: str, device=None):
    """Load an artifact written by :func:`save_compiled`. Returns
    ``fn(inputs: list, as_numpy=True) -> list`` running the program with
    its stored payloads on the device it was traced for (a CUDA artifact
    with no card raises; another ``device`` raises ValueError). A file
    that is not a port artifact, a JAX artifact and a decode-loop
    artifact raise ValueError."""
    meta, dev, run = _load(path, "forward", device)
    bound = {int(i): (tuple(shape), bytes.fromhex(data))
             for i, (shape, data) in meta["bound"].items()}

    def fn(inputs: list, as_numpy: bool = True) -> list:
        if len(inputs) != meta["n_inputs"]:
            raise ValueError(f"expected {meta['n_inputs']} inputs, got "
                             f"{len(inputs)}")
        for i, (shape, data) in bound.items():
            a = np.asarray(inputs[i])
            if a.shape != shape or a.tobytes() != data:
                raise ValueError(f"input {i} is baked into the artifact: "
                                 "it must equal the example input")
        outs = run([_as_device(a, dev) for i, a in enumerate(inputs)
                    if i not in bound])
        if as_numpy:
            return [o.cpu().numpy() for o in outs]
        return outs

    fn.program = run  # its captured graphs and replay count
    return fn


# -- the decode loop --------------------------------------------------------

# generate_kv's options a decode artifact bakes in (JAX's save_decode_loop)
_GEN_KW = ("temperature", "top_k", "top_p", "min_p", "repetition_penalty",
           "kv_cache_dtype", "rope", "score_bias")


def save_decode_loop(step_model, path: str, wte, wpe, example_prompt,
                     max_new_tokens: int, devices=None, generator=None,
                     key=None, **gen_kw) -> dict:
    """Export the whole decode loop of :func:`utils.generate.generate_kv`
    (teacher-forced prefill and generation, ``t0 + max_new_tokens - 1``
    steps of :func:`utils.generate._kv_step` in one ``while_loop``) with
    the step model's payloads and the embedding, RoPE, score-bias and
    step-mask tables beside it, to ``path``. The prompt's shape and
    ``max_new_tokens`` are baked in; the prompt's values are the
    program's input, and a sampling loop takes its Gumbel noise [steps,
    B, V] as a second input (load_decode_loop draws it from a generator,
    in generate_kv's order). The loop counter lives on the host (no
    device read decides a step), positions on the device; the caches are
    carried functionally, each step writing a new cache.

    ``gen_kw``: generate_kv's temperature, top_k, top_p, min_p,
    repetition_penalty, kv_cache_dtype, rope and score_bias. ``memory=``
    raises ValueError (a seq2seq decode artifact is not supported, as in
    the JAX package); a JAX ``key`` raises NotImplementedError. A
    generate_kv run first (``generator`` for its sampling) places every
    table and host array the walk reads. Returns what
    :func:`save_compiled` returns."""
    from .generate import (_cache_quantizer, _cache_start, _kv_layout,
                           _kv_step, _placed_table, _refuse_key, _sampling,
                           _step_masks, generate_kv)

    _refuse_key(key)
    if gen_kw.get("memory") is not None:
        raise ValueError("memory=: a decode artifact has no encoder-memory "
                         "input (the JAX package's leaves it empty too)")
    gen_kw.pop("memory", None)
    unknown = set(gen_kw) - set(_GEN_KW)
    if unknown:
        raise TypeError(f"save_decode_loop takes no {sorted(unknown)}")
    dev = _traced_device(step_model, devices)
    prompt = np.asarray(example_prompt)
    batch, t0 = prompt.shape
    generate_kv(step_model, prompt, wte, wpe, max_new_tokens,
                generator=generator, **gen_kw)
    rope, bias = gen_kw.get("rope"), gen_kw.get("score_bias")
    cache_start = _cache_start(step_model, rope, bias is not None)
    _, _, nh, length, hd = _kv_layout(step_model, cache_start)
    q_cache, _ = _cache_quantizer(step_model, gen_kw.get("kv_cache_dtype"),
                                  cache_start)
    knobs = {k: gen_kw.get(k) for k in ("temperature", "top_k", "top_p",
                                        "min_p", "repetition_penalty")}
    sampling = _sampling(knobs)
    penalty = knobs["repetition_penalty"] is not None
    steps = t0 + max_new_tokens - 1
    tables = dict(
        wte=_placed_table(step_model, "wte", wte),
        wpe=_placed_table(step_model, "wpe", wpe),
        rope_cos=None if rope is None
        else _placed_table(step_model, "rope_cos", rope[0]),
        rope_sin=None if rope is None
        else _placed_table(step_model, "rope_sin", rope[1]),
        bias=_placed_table(step_model, "score_bias", bias),
        masks=_step_masks(steps, length, dev))
    vocab = int(tables["wte"].shape[0])
    walk = step_model._bound_fn({})

    def start(prompt_ids):
        """The loop's state before step 0: ids, caches[, presence]."""
        ids = torch.cat([prompt_ids.to(torch.int64), torch.zeros(
            (batch, max_new_tokens), dtype=torch.int64, device=dev)], 1)
        caches = [q(torch.zeros((batch, nh, length, hd), dtype=torch.float32,
                                device=dev)) for q in q_cache]
        presence = [torch.zeros((batch, vocab), dtype=torch.float32,
                                device=dev).scatter(1, ids[:, :1], 1.0)] \
            if penalty else []
        return (ids, *caches, *presence)

    def one_step(payloads, tabs, state, pos, noise):
        """generate_kv's step t = pos over ``state``; the new state."""
        ids, *caches = state
        presence = caches.pop() if penalty else None
        tab = dict(wte=tabs["wte"], wpe=tabs.get("wpe"), bias=tabs.get("bias"),
                   masks=tabs["masks"], memory=[],
                   rope=None if rope is None
                   else (tabs["rope_cos"], tabs["rope_sin"]))
        with _reading(step_model, payloads):
            _, ids, caches, presence = _kv_step(
                walk, tab, ids, caches, presence, pos, t0, q_cache, knobs,
                noise=noise.index_select(0, pos)[0] if sampling else None,
                functional=True)
        return (ids, *caches) + ((presence,) if penalty else ())

    # The tensors a step reads besides its state, payloads and tables
    # (placed host arrays: per-channel scales, zero points, indices),
    # found by one eager step: a while_loop body cannot hold a tensor of
    # its own, so the loop takes them as operands.
    prompt_t = torch.from_numpy(prompt.astype(np.int32)).to(dev)
    noise0 = torch.zeros((steps, batch, vocab) if sampling else (0,),
                         dtype=torch.float32, device=dev)
    payloads = _payloads(step_model)
    keys = [k for k, t in tables.items() if t is not None]
    with torch.no_grad():
        state = start(prompt_t)
        known = [*payloads.values(), *(tables[k] for k in keys), *state,
                 noise0]
        with _Reads(known) as reads:
            one_step(payloads, tables, state,
                     torch.zeros((1,), dtype=torch.int64, device=dev), noise0)
    consts = list(reads.found.values())
    n_state, n_pay = len(state), len(payloads)

    def body(payloads, tabs, prompt_ids, noise=noise0):
        operands = (*payloads.values(), *(tabs[k] for k in keys), noise,
                    *consts)

        def more(i, pos, *rest):
            return i < steps

        def step(i, pos, *rest):
            state, ops = rest[:n_state], rest[n_state:]
            pl = dict(zip(payloads, ops[:n_pay]))
            tb = dict(zip(keys, ops[n_pay:n_pay + len(keys)]))
            nz = ops[n_pay + len(keys)]
            cs = ops[n_pay + len(keys) + 1:]
            with _Substitute(dict(zip(map(id, consts), cs))):
                return (i + 1, pos + 1) + one_step(pl, tb, state, pos, nz)

        # the step counter lives on the host: the loop's condition reads no
        # device value, so a replay needs no sync and the whole loop can be
        # captured into one CUDA graph; positions live on the device
        out = while_loop_op(more, step, (
            torch.zeros((), dtype=torch.int64),
            torch.zeros((1,), dtype=torch.int64, device=dev))
            + start(prompt_ids), operands)
        return out[2].to(torch.int32)

    args = (prompt_t,) + ((noise0,) if sampling else ())
    return _export(_Program(step_model, body, tables), args, path, dict(
        kind="decode", device=str(dev), prompt_shape=[batch, t0],
        steps=steps, vocab=vocab, sampling=sampling))


class _Reads(TorchFunctionMode):
    """Records, by identity, the tensors the torch calls inside read that
    they did not make and that are not ``known``."""

    def __init__(self, known):
        super().__init__()
        self.skip = {id(t) for t in known}
        self.made, self.found = set(), {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensor_leaves((args, kwargs)):
            i = id(t)
            if i not in self.made and i not in self.skip:
                self.found.setdefault(i, t)
        out = func(*args, **kwargs)
        self.made.update(id(t) for t in _tensor_leaves(out))
        return out


class _Substitute(TorchFunctionMode):
    """Torch calls inside read ``table[id(t)]`` wherever they are handed
    the tensor ``t``."""

    def __init__(self, table: dict):
        super().__init__()
        self.table = table

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = tree_map_only(
            torch.Tensor, lambda t: self.table.get(id(t), t),
            (args, kwargs or {}))
        return func(*args, **kwargs)


def _tensor_leaves(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def load_decode_loop(path: str, device=None):
    """Load a :func:`save_decode_loop` artifact. Returns
    ``fn(prompt_ids, generator=None) -> ids`` running the whole decode
    loop with the stored payloads and tables (numpy in, int32 numpy out,
    the prompt included). A sampling loop draws its noise from
    ``generator`` (a fresh one seeded 0 on the artifact's device when
    None) in generate_kv's order, so the same seed gives generate_kv's
    tokens. On CUDA each call replays one captured CUDA graph of the
    whole loop. A forward artifact raises ValueError."""
    from .generate import _gumbel, _refuse_key

    meta, dev, run = _load(path, "decode", device)
    batch, t0 = meta["prompt_shape"]

    def fn(prompt_ids, generator: torch.Generator = None, key=None):
        _refuse_key(key)
        prompt = np.asarray(prompt_ids)
        if prompt.shape != (batch, t0):
            raise ValueError(f"the artifact decodes prompts of shape "
                             f"{(batch, t0)}, not {prompt.shape}")
        args = [torch.from_numpy(prompt.astype(np.int32)).to(dev)]
        if meta["sampling"]:
            gen = generator if generator is not None \
                else torch.Generator(device=dev).manual_seed(0)
            args.append(torch.stack([
                _gumbel((batch, meta["vocab"]), gen).to(dev)
                for _ in range(meta["steps"])]))
        return run(args)[0].cpu().numpy()

    fn.program = run  # its captured graphs and replay count
    return fn
