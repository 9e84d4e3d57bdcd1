"""Device meshes over ``torch.distributed`` (port of
``numpy_quant_tpu/parallel/mesh.py``), plus what SPMD over processes needs
and JAX got from one process: a launcher for the ranks and collective
helpers over a mesh axis.

One process per rank runs the same program; every rank is given the same
global input and returns the global output. A :class:`Mesh` holds the
ranks in an N-D array named by axes (JAX's ``("data",)``, ``("data",
"model")``, ``("pipe", "model")``) and one process group per line along
each axis. It is the port's own object and not
``torch.distributed.device_mesh.DeviceMesh``: several ranks share one card
here (gloo over ``cuda:0``), and pipelines need meshes over a subset of
the world (one per pipeline row) built in the same collective order on
every rank.

Backends: ``"gloo"`` (the CPU, and several ranks sharing one card: every
collective stages a CUDA tensor through the host) or ``"nccl"`` (one card
per rank; asking for it with more ranks than cards raises).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as _queue
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# process groups by their tuple of global ranks, for the life of the
# process (a group belongs to the process, not to one mesh): new_group is
# collective over the world, so every rank makes the same calls in the same
# order, and a mesh built again reuses its groups
_GROUPS: dict = {}


def _group(ranks: tuple):
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    g = _GROUPS.get(ranks)
    if g is None:
        g = _GROUPS[ranks] = dist.new_group(list(ranks))
    return g


class Mesh:
    """An N-D array of global ranks with named axes. ``shape`` maps each
    axis name to its size (as a JAX mesh's does); ``coords`` is this rank's
    position (None off the mesh); ``device`` the device the ranks compute
    on (CUDA unless given)."""

    def __init__(self, ranks, axis_names: tuple, device=None):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} and axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.device = torch.device("cuda" if device is None else device)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        rank = dist.get_rank() if dist.is_initialized() else 0
        hit = np.argwhere(self.devices == rank)
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None
        self._groups = {}
        if dist.is_initialized():
            # every line along every axis, on every rank, in one order
            for ax, name in enumerate(self.axis_names):
                lines = np.moveaxis(self.devices, ax, -1).reshape(
                    -1, self.devices.shape[ax])
                for line in lines:
                    g = _group(tuple(int(r) for r in line))
                    if rank in line:
                        self._groups[name] = (g, tuple(int(r) for r in line))
            everyone = tuple(int(r) for r in self.devices.reshape(-1))
            g = _group(everyone)
            if rank in everyone:
                self._groups[None] = (g, everyone)

    @property
    def member(self) -> bool:
        return self.coords is not None

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis):
        """(process group, global ranks in axis order) of this rank's line
        along ``axis``; ``axis=None``: the whole mesh."""
        return self._groups[axis]

    def row(self, axis: str, index: int, names: tuple = None) -> "Mesh":
        """The sub-mesh at ``index`` along ``axis`` (that axis dropped):
        a pipeline stage's ``("model",)`` row."""
        ax = self.axis_names.index(axis)
        sub = np.take(self.devices, index, axis=ax)
        rest = names or tuple(n for n in self.axis_names if n != axis)
        return Mesh(sub, rest, self.device)

    def __repr__(self):
        return (f"Mesh({self.shape}, backend={self.backend}, "
                f"device={self.device})")


def make_mesh(n_devices: int | None = None, axes: tuple = ("data",),
              shape: tuple | None = None, device=None) -> Mesh:
    """1-D (default) or N-D mesh over the first ``n_devices`` ranks of the
    world. Collective: every rank of the world calls it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"{n_devices} ranks asked of a world of {world}")
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} "
                         "ranks")
    return Mesh(np.arange(n_devices).reshape(shape), axes, device)


def make_dp_tp_mesh(n_devices: int, tp: int, device=None) -> Mesh:
    """2-D (data, model) mesh: DP outer, TP inner, as the JAX package
    lays it out."""
    if n_devices % tp:
        raise ValueError(f"tp={tp} does not divide {n_devices} ranks")
    return make_mesh(n_devices, axes=("data", "model"),
                     shape=(n_devices // tp, tp), device=device)


def replicated(mesh: Mesh) -> tuple:
    """Placement of a value every rank holds whole: the empty spec."""
    return ()


def batch_sharded(mesh: Mesh, axis: str = "data", ndim: int = 1) -> tuple:
    """Placement of a value split along its leading axis over ``axis``."""
    return (axis,) + (None,) * (ndim - 1)


# ----------------------------------------------------------------------
# Collectives over a mesh axis. gloo moves CUDA tensors through the host.
# ----------------------------------------------------------------------


def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    return t.device.type == "cuda" and mesh.backend != "nccl"


def axis_size(mesh: Mesh, axis) -> int:
    return mesh.size if axis is None else mesh.shape[axis]


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, mesh: Mesh, axis, op: str = "sum"):
    """``t`` reduced over ``axis`` (None: the whole mesh); a new tensor
    on ``t``'s device."""
    if axis_size(mesh, axis) == 1:
        return t
    group, _ = mesh.group(axis)
    buf = t.cpu() if _staged(t, mesh) else t.clone()
    buf = buf.contiguous()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh, axis, dim: int = 0):
    """The pieces of every rank along ``axis``, concatenated along
    ``dim`` in axis order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    group, _ = mesh.group(axis)
    src = (t.cpu() if _staged(t, mesh) else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast(t: torch.Tensor, mesh: Mesh, axis, src_index: int):
    """``t`` of the rank at ``src_index`` along ``axis`` on every rank of
    that line (the others pass a tensor of the same shape and dtype)."""
    if axis_size(mesh, axis) == 1:
        return t
    group, ranks = mesh.group(axis)
    buf = (t.cpu() if _staged(t, mesh) else t.clone()).contiguous()
    dist.broadcast(buf, src=ranks[src_index], group=group)
    return buf.to(t.device)


def send(t: torch.Tensor, dst_rank: int) -> None:
    """Point to point to a global rank (through the host: gloo's send
    takes CPU tensors)."""
    dist.send(t.detach().cpu().contiguous(), dst=dst_rank)


def recv(shape, dtype, src_rank: int, device) -> torch.Tensor:
    buf = torch.empty(tuple(shape), dtype=dtype)
    dist.recv(buf, src=src_rank)
    return buf.to(device)


# ----------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------


def _rank_main(rank, world, backend, device, init_file, timeout_s, threads,
               tasks, results):
    if threads:
        torch.set_num_threads(threads)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
    except Exception:  # noqa: BLE001 -- reported to the launcher
        results.put((rank, "err", traceback.format_exc()))
        return
    results.put((rank, "up", None))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            out = fn(*args, **kwargs)
            results.put((rank, "ok", out))
        except Exception:  # noqa: BLE001 -- reported to the launcher
            results.put((rank, "err", traceback.format_exc()))
            break
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass


class RankError(RuntimeError):
    """A rank raised; the message holds its traceback."""


class Ranks:
    """``world`` live rank processes on one host joined in one process
    group. ``run(fn, *args)`` has every rank call ``fn(*args)`` (``fn``
    importable by name: a module-level function) and returns their
    results in rank order; ranks keep their module state between calls,
    so a file spawns its ranks once and feeds them cases. A rank that
    raises, or a call that outlives its deadline, kills every rank and
    raises (the rank's traceback, or TimeoutError). ``init_method`` is a
    fresh temp file: concurrent launchers never share a port."""

    def __init__(self, world: int, *, backend: str = "gloo",
                 device="cuda", timeout_s: float = 300.0,
                 threads: int | None = None):
        dev = torch.device(device)
        if backend == "nccl" and dev.type == "cuda":
            cards = torch.cuda.device_count()
            if world > cards:
                raise ValueError(
                    f"nccl cannot put {world} ranks on {cards} card(s): two "
                    "ranks on one device need backend='gloo'")
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("nccl needs CUDA ranks")
        self.world = world
        self.timeout_s = float(timeout_s)
        ctx = mp.get_context("spawn")
        fd, self._init_file = tempfile.mkstemp(prefix="nq_pg_")
        os.close(fd)
        os.unlink(self._init_file)
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, world, backend, str(dev), self._init_file,
                  self.timeout_s, threads, self._tasks[r], self._results),
            daemon=True) for r in range(world)]
        for p in self._procs:
            p.start()
        self._collect(self.timeout_s)

    def _collect(self, timeout_s: float) -> list:
        deadline = time.monotonic() + timeout_s
        out = [None] * self.world
        seen = 0
        while seen < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                self.close(kill=True)
                raise TimeoutError(
                    f"{self.world - seen} rank(s) did not answer within "
                    f"{timeout_s:.0f} s; every rank was killed")
            try:
                rank, status, value = self._results.get(
                    timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and out[r] is None]
                if dead and self._results.empty():
                    time.sleep(0.5)
                    if self._results.empty():
                        self.close(kill=True)
                        raise RankError(f"rank(s) {dead} exited without a "
                                        "result")
                continue
            if status == "err":
                self.close(kill=True)
                raise RankError(f"rank {rank} raised:\n{value}")
            out[rank] = value
            seen += 1
        return out

    def run(self, fn, *args, timeout_s: float | None = None, **kwargs):
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect(timeout_s or self.timeout_s)

    def close(self, kill: bool = False) -> None:
        procs, self._procs = getattr(self, "_procs", []), []
        if not kill:
            for q in self._tasks:
                try:
                    q.put(None)
                except Exception:  # noqa: BLE001
                    pass
            for p in procs:
                p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        try:
            os.unlink(self._init_file)
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)
        return False


def spawn(fn, world: int, *args, backend: str = "gloo", device="cuda",
          timeout_s: float = 300.0, threads: int | None = None, **kwargs):
    """Start ``world`` ranks, have each call ``fn(*args, **kwargs)``,
    join them within ``timeout_s`` and return their results in rank
    order. A rank that raises kills the rest and raises its traceback."""
    with Ranks(world, backend=backend, device=device, timeout_s=timeout_s,
               threads=threads) as ranks:
        return ranks.run(fn, *args, **kwargs)
