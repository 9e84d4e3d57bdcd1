"""The work counts behind mfu and the rooflines, against hand counts and
against the launches the program makes at a tiny size on the CPU."""
import collections

import pytest
import torch

from benchmark.common import harness, peaks, readers
from benchmark.common.trace import Trace
from benchmark.tests import tiny


def test_vit_operations_per_image_by_hand():
    c = harness.Cell.find("vit_int8.offline")
    conv = 196 * 768 * (3 * 16 * 16) * 2
    linear = 2 * 197 * (4 * 768 * 768 + 2 * 768 * 3072)
    attention = 2 * 2 * 197 * 197 * 768
    head = 2 * 768 * 1000
    want = conv + 12 * (linear + attention) + head
    assert c.config.ops_per_image(c.spec) == want
    assert want == pytest.approx(35.13e9, rel=1e-3)


def test_gpt2_operations_per_token_by_hand():
    c = harness.Cell.find("gpt2_w4.batch")
    w = c.config.Work(c.spec)
    per_layer = 2 * (768 * 2304 + 768 * 768 + 768 * 3072 + 3072 * 768)
    head = 2 * 768 * 50257
    assert w.decode_flops(500) == 12 * per_layer + head + 4 * 768 * 500 * 12
    assert w.decode_flops(500) == pytest.approx(0.266e9, rel=1e-2)
    assert w.prefill_flops(3) == 3 * 12 * per_layer + head \
        + 4 * 768 * 12 * (1 + 2 + 3)


def test_least_time_takes_the_larger_bound():
    h100 = peaks.peaks("NVIDIA H100 80GB HBM3")
    ops, nbytes = peaks.matmul_work(18912, 3072, 768, 1, 8, 4, 4 * 768)
    assert ops == 2 * 18912 * 3072 * 768
    assert nbytes == 18912 * 3072 + 3072 * 768 + 4 * 768 + 18912 * 768 * 4
    t = peaks.least_seconds(ops, nbytes, h100, "int8")
    assert t == max(ops / 1979e12, nbytes / 3.35e12)
    with pytest.raises(ValueError):
        peaks.peaks("NVIDIA A100")


def _recorded(module, names, fn):
    """Calls of ``module``'s wrappers ``names`` during ``fn()``, by
    (name, x rows, k, n)."""
    seen = collections.Counter()
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, f):
        def g(x, w, *a, **k):
            n_out = w.shape[-1]
            seen[(name, x.shape[0], x.shape[-1], n_out)] += 1
            return f(x, w, *a, **k)
        g.__name__ = name
        return g

    try:
        for n, f in saved.items():
            setattr(module, n, wrap(n, f))
        fn()
    finally:
        for n, f in saved.items():
            setattr(module, n, f)
    return seen


def test_vit_products_are_the_launches_the_program_makes():
    import numpy_quant_tpu_torch.kernels.qmatmul as Q
    c = tiny.cell("vit_int8.offline")
    c.spec["num_hidden_layers"] = 3
    system = c.config.build(c.spec, c.mix, 3, torch.device("cpu"))
    x = torch.zeros((4, 3, 32, 32))
    seen = _recorded(Q, ("splitk_qmatmul",), lambda: system.model([x]))
    want = collections.Counter()
    for p in c.config.qmatmul_products(c.spec, 4):
        want[("splitk_qmatmul", p["m"], p["k"], p["n"])] += p["count"]
    assert seen == want


def test_gpt2_products_are_the_launches_the_program_makes():
    import numpy_quant_tpu_torch.kernels.qmatmul as Q
    c = tiny.cell("gpt2_w4.batch")
    system = c.config.build(c.spec, c.mix, 3, torch.device("cpu"))
    eng = system.engine

    def one_step():
        eng.submit([1, 2, 3], 2)
        eng.step()

    seen = _recorded(Q, ("splitk_wo_matmul",), one_step)
    want = collections.Counter()
    sv = c.spec["serving"]
    for rows in (sv["slots"], sv["prefill_len"]):
        for p in c.config.wo_products(c.spec, rows):
            want[("splitk_wo_matmul", p["m"], p["k"], p["n"])] += p["count"]
    assert seen == want


class _Run:
    def __init__(self, trace):
        self.trace = trace
        self.peak = peaks.PEAKS["H100"]


def test_roofline_counts_launches_or_reads_nothing():
    prod = [dict(ops=2e12, bytes=1.0, precision="int8", count=2)]
    least = 2e12 / 1979e12
    trace = Trace(wall_s=1.0, counts={"forward": 3},
                  device=[("k_kernel", i * 10.0, 1e6 * least * 2)
                          for i in range(6)])
    got = readers.roofline(_Run(trace), "k_kernel", {"forward": prod})
    assert got == pytest.approx(50.0)
    trace.device.pop()
    assert readers.roofline(_Run(trace), "k_kernel", {"forward": prod}) \
        is None
    assert readers.roofline(_Run(None), "k_kernel", {"forward": prod}) \
        is None


def test_idle_share_is_the_union_of_device_intervals():
    trace = Trace(wall_s=1e-3, device=[("a", 0.0, 400.0), ("b", 200.0,
                                                           400.0),
                                       ("c", 800.0, 100.0)])
    assert trace.busy_s() == pytest.approx(700e-6)
    assert readers.idle_share(_Run(trace)) == pytest.approx(30.0)
    assert trace.idle_gaps() == [(600.0, 800.0)]
