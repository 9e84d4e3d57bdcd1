"""Profile visualization and device traces (port of
``numpy_quant_tpu/utils/profiling.py``).

``profile_results_plot`` draws the per-op-type times of two profile-mode
forwards (``Model.__call__(..., profile=True)``) as the JAX package's ASCII
chart. ``device_trace`` runs a function under ``torch.profiler`` and
writes its chrome trace; ``summarize_device_trace`` and
``device_busy_seconds`` read the device's kernels back from it -- the only
place that knows where a captured forward's time went, since a replayed
CUDA graph runs no Python per node.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import tempfile
import time

# chrome-trace categories of work that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_results_plot(profile_results: dict[str, float],
                         q_profile_results: dict[str, float],
                         show: int = 5, width: int = 50) -> str:
    """Render (and print) the comparison chart; returns the string."""
    q_sorted = dict(sorted(q_profile_results.items(), key=lambda kv: -kv[1]))
    labels = list(q_sorted)[:show]
    qvals = [q_sorted[k] for k in labels]
    fvals = [profile_results.get(k, 0.0) for k in labels]
    peak = max(qvals + fvals + [1e-12])
    name_w = max((len(l) for l in labels), default=0)

    lines = ["Profile quantized vs. float"]
    for label, qv, fv in zip(labels, qvals, fvals):
        qbar = "#" * max(1, int(width * qv / peak)) if qv > 0 else ""
        fbar = "=" * max(1, int(width * fv / peak)) if fv > 0 else ""
        lines.append(f"{label:<{name_w}} quantized |{qbar} {qv * 1e3:.1f}ms")
        lines.append(f"{'':<{name_w}} float32   |{fbar} {fv * 1e3:.1f}ms")
    out = "\n".join(lines)
    print(out)
    return out


def device_trace(fn, *args, trace_dir: str = None):
    """Run ``fn(*args)`` under ``torch.profiler`` (CPU and, where there is
    a card, CUDA activity), wait for the device, and write the chrome
    trace as ``<trace_dir>/trace-<ns>.json`` (a directory under the
    temporary directory by default). Returns fn's result."""
    import torch

    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(),
                                          "nq_torch_trace")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace-{time.time_ns()}.json"))
    return out


def _last_trace(trace_dir: str) -> dict:
    files = glob.glob(os.path.join(trace_dir, "*.json")) \
        + glob.glob(os.path.join(trace_dir, "*.json.gz"))
    if not files:
        raise FileNotFoundError(f"no chrome trace (*.json) under "
                                f"{trace_dir}")
    path = max(files, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh)


def summarize_device_trace(trace_dir: str, top: int = 20,
                           group_stems: bool = True) -> list[tuple]:
    """Device time by kernel in the newest chrome trace under
    ``trace_dir`` (``device_trace``'s, or any ``export_chrome_trace``
    file): ``[(kernel name, total seconds, count), ...]`` sorted by total
    time. Only complete events of device work count (kernels, copies and
    fills); a graph replay's host-side launch is not one, so a replayed
    graph's kernels count once each. ``group_stems=True`` merges the
    instances of one kernel: a C++ name's template and argument lists and
    a numbered suffix (``name.3``) are dropped."""
    events = _last_trace(trace_dir).get("traceEvents", [])
    agg = collections.Counter()
    cnt = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES \
                or "dur" not in e:
            continue
        name = e["name"]
        if group_stems:
            name = _stem(name)
        agg[name] += float(e["dur"])
        cnt[name] += 1
    return [(k, v / 1e6, cnt[k]) for k, v in agg.most_common(top)]


def _stem(name: str) -> str:
    """``void ns::kernel<8, true>(Params)`` -> ``ns::kernel``;
    ``fusion.12`` -> ``fusion``."""
    name = re.sub(r"^void ", "", name)
    for sep in ("<", "("):
        if sep in name:
            name = name[:name.index(sep)]
    return re.sub(r"\.\d+$", "", name.strip())


def dot_kernels(dot: str) -> collections.Counter:
    """Kernel nodes by function symbol (as mangled) in a CUDA graph's DOT
    print (``cuGraphDebugDotPrint``): each kernel node's label holds
    ``symbol<<<grid,block,smem>>>``."""
    return collections.Counter(re.findall(r"\| ([A-Za-z_]\w*)\\<\\<\\<",
                                          dot))


def graph_kernels(model) -> list:
    """[(signature, Counter({kernel symbol: nodes}))] of every forward
    ``model`` has captured (CUDA only), read from the graph itself: the
    driver prints each kept cudaGraph_t as DOT and ``dot_kernels`` counts
    its kernel nodes. A device trace of a replay may leave records out;
    the graph holds every kernel a replay launches."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")
    out = []
    for key, entry in model._graphs.items():
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "graph.dot")
            rc = libcuda.cuGraphDebugDotPrint(
                ctypes.c_void_p(entry.graph.raw_cuda_graph()),
                path.encode(), ctypes.c_uint(1))
            if rc != 0:
                raise RuntimeError(f"cuGraphDebugDotPrint failed: CUDA "
                                   f"error {rc}")
            with open(path) as fh:
                out.append((key, dot_kernels(fh.read())))
    return out


def device_busy_seconds(trace_dir: str) -> float:
    """Total device seconds of the newest trace under ``trace_dir``: the
    sum of its device events' durations (summarize_device_trace's
    events, all of them)."""
    rows = summarize_device_trace(trace_dir, top=None, group_stems=False)
    return float(sum(sec for _, sec, _ in rows))
