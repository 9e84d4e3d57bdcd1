"""The device trace of a traced run: torch.profiler over a stretch of the
window, read back from its chrome trace.

The busy time is the union of the device operations' intervals (kernels,
copies, fills), so overlapping streams count once; the idle share is what
the union leaves of the traced wall. A trace that holds no device record
is taken again (the retry of the repository's chip_smoke.py ``profiled``,
copied here), and gives None, never 0, where no try saw the device."""
from __future__ import annotations

import heapq
import json
import os
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


@dataclass
class Trace:
    wall_s: float                        # the traced stretch, host clock
    device: list = field(default_factory=list)  # (name, start_us, dur_us)
    host: list = field(default_factory=list)    # (name, start_us, dur_us)
    counts: dict = field(default_factory=dict)  # what the stretch ran

    def records(self, fragment: str) -> list:
        """The device records whose name holds ``fragment``."""
        return [r for r in self.device if fragment in r[0]]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of their
        intervals."""
        return sum(e - s for s, e in _union(self.device)) / 1e6

    def idle_gaps(self) -> list:
        """(start_us, end_us) of each stretch between device operations,
        inside the span the device records cover."""
        spans = _union(self.device)
        return [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]


def _union(records: list) -> list:
    spans = sorted((s, s + d) for _, s, d in records)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Tracer:
    """torch.profiler (CPU and CUDA) started and stopped between two
    synchronizations, its chrome trace written to ``path`` (a fixed file
    inside the checkout, removed once read)."""

    def __init__(self, path: str):
        self.path = path
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, counts: dict):
        """The Trace of the stretch since :meth:`start`, or None where it
        holds no device record. ``counts``: what the stretch ran."""
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        trace = read_chrome_trace(self.path, wall, counts)
        os.remove(self.path)
        return trace if trace.device else None


def profiled(run, path: str, tries: int = 3):
    """``run()`` traced by a :class:`Tracer`; ``run`` returns the counts of
    what it ran. A trace with no device record is taken again, at most
    ``tries`` times in all. Returns the Trace, or None where no try saw
    the device."""
    for _ in range(tries):
        tracer = Tracer(path)
        tracer.start()
        trace = tracer.stop(run())
        if trace is not None:
            return trace
    return None


def read_chrome_trace(path: str, wall_s: float, counts: dict) -> Trace:
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    trace = Trace(wall_s=wall_s, counts=dict(counts))
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        rec = (str(ev.get("name", "")), float(ev["ts"]), float(ev["dur"]))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            trace.device.append(rec)
        elif cat in HOST_CATS:
            trace.host.append(rec)
    return trace


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps summed by what the host was doing in them: the shortest host
    event that covers a gap's middle (the innermost span or call)."""
    ops: dict = {}
    for name, _, dur in trace.device:
        ops[name] = ops.get(name, 0.0) + dur / 1e6
    gaps: dict = {}
    host = sorted(trace.host, key=lambda r: r[1])
    live: list = []   # heap of (end, dur, name) of host events begun
    i = 0
    for s, e in trace.idle_gaps():   # in time order
        mid = (s + e) / 2
        while i < len(host) and host[i][1] <= mid:
            name, start, dur = host[i]
            heapq.heappush(live, (start + dur, dur, name))
            i += 1
        while live and live[0][0] < mid:
            heapq.heappop(live)
        inner = [h for h in live if h[0] >= mid]
        name = min(inner, key=lambda h: h[1])[2] if inner \
            else "(no host event)"
        gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:120], v] for k, v in order(ops)],
            "idle_gaps": [[k[:120], v] for k, v in order(gaps)]}
