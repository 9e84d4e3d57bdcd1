"""The arithmetic the per-layer readers share: roofline shares from the
device trace, shares of a peak from the untraced stretch's rates, and the
device's idle share. Each returns None where it finds nothing to read."""
from __future__ import annotations

from . import peaks as _peaks


def roofline(run, fragment: str, per_call: dict) -> float | None:
    """Percent: the least time of the launches the traced stretch made,
    over the device time of the records whose name holds ``fragment``.
    ``per_call`` maps each kind of call the stretch counted (a forward, a
    decode step, a prefill) to its launches, each a dict with ``count``
    and either m/k/n/x_bytes/w_bits/out_bytes/scale_bytes or ops/bytes,
    and ``precision``. None where the trace is missing or the records are
    not the launches the calls make."""
    trace = run.trace
    if trace is None:
        return None
    least, launches = 0.0, 0
    for call, products in per_call.items():
        calls = trace.counts.get(call, 0)
        for p in products:
            if "ops" in p:
                ops, nbytes = p["ops"], p["bytes"]
            else:
                ops, nbytes = _peaks.matmul_work(
                    p["m"], p["k"], p["n"], p["x_bytes"], p["w_bits"],
                    p["out_bytes"], p["scale_bytes"])
            least += calls * p["count"] * _peaks.least_seconds(
                ops, nbytes, run.peak, p["precision"])
            launches += calls * p["count"]
    records = trace.records(fragment)
    if not records or len(records) != launches:
        return None
    return 100.0 * least / (sum(r[2] for r in records) / 1e6)


def peak_share(ops_per_s: float, run, precision: str) -> float | None:
    """Percent of the ``precision`` peak that ``ops_per_s`` reaches."""
    if not ops_per_s:
        return None
    return 100.0 * ops_per_s / run.peak[precision]


def idle_share(run) -> float | None:
    """Percent of the traced stretch in which no device operation ran."""
    trace = run.trace
    if trace is None or trace.wall_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s() / trace.wall_s)
