"""BENCHMARK.json against the rules its harness relies on: names and units
of the allowed characters, every name leading to its files, every
per-layer metric reported where its end-to-end metric is; a cell added
as new files and an entry (a new mix, arrival process, length
distribution or loop) is found and runs without an edit to an existing
file; a run imports no JAX module."""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

from benchmark.common import harness
from benchmark.tests import tiny

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units_use_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(names) == len(set(names))


def test_every_name_leads_to_its_files():
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert os.path.isfile(os.path.join(harness.BENCH, "configs",
                                           c["name"] + ".py"))
    for w in BENCH["workloads"]:
        assert os.path.isfile(os.path.join(harness.BENCH, "traffic",
                                           w["traffic"] + ".json"))
        mix = harness.load_json(os.path.join(harness.BENCH, "traffic",
                                             w["traffic"] + ".json"))
        named = [("loops", mix["kind"])]
        if "arrivals" in mix:
            named += [("arrivals", mix["arrivals"]),
                      ("lengths", mix["prompt"]["dist"]),
                      ("lengths", mix["output"]["dist"])]
        for group, name in named:
            assert os.path.isfile(os.path.join(harness.BENCH, group,
                                               name + ".py"))
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(harness.BENCH, "metrics",
                                           m["name"] + ".py"))


def test_per_layer_metrics_ride_with_the_metric_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["numpy_quant_tpu_torch", "numpy_quant_tpu_torch.model",
             "numpy_quant_tpu", "numpy_quant_tpu.model", "jax.numpy",
             "jaxlib", "flax.linen", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "numpy_quant_tpu",
        "numpy_quant_tpu.model"]


def test_a_run_imports_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.common.harness import forbidden_modules\n"
        "for name in ('vit_int8.offline', 'gpt2_w4.chat'):\n"
        "    tiny.run(tiny.cell(name), seconds=0.3)\n"
        "print(forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _checkout(tmp_path):
    """A copy of the benchmark's files to add to; BENCHMARK.json as a
    dict."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root, json.loads(json.dumps(BENCH))


def test_a_cell_added_as_files_and_an_entry_runs(tmp_path):
    root, bench = _checkout(tmp_path)
    mix = harness.load_json(os.path.join(harness.BENCH, "traffic",
                                         "chat.json"))
    mix.update(rate=11.0, shape_seed=7)
    (root / "benchmark" / "traffic" / "chat_slow.json").write_text(
        json.dumps(mix))
    bench["workloads"].append({"name": "gpt2_w4.chat_slow",
                               "config": "gpt2_small_w4",
                               "traffic": "chat_slow", "chips": 1,
                               "why": "a slower open loop"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.Cell.find("gpt2_w4.chat_slow", str(root))
    assert c.mix["rate"] == 11.0
    assert [m["name"] for m in c.end_to_end] == ["setup_s"]
    record, checks, correct = tiny.run(tiny.shrink(c), seconds=0.5)
    assert correct and record.attempted > 0


GAMMA = """import numpy as np


def due(mix, shape, order, seconds):
    k = 1.0 / mix["cv"] ** 2
    gaps, t = [], 0.0
    while True:
        g = shape.gamma(k, 1.0 / (k * mix["rate"]))
        if t + g >= seconds:
            return np.cumsum(order.permutation(np.asarray(gaps)))
        gaps.append(g)
        t += g
"""

TWO_POINT = """import numpy as np


def draw(dist, n, rng):
    return np.where(rng.random(n) < dist["share"], dist["max"], dist["min"])
"""


def test_a_new_arrival_process_and_length_distribution_are_files(tmp_path):
    """The first cell PERF.md keeps for later, bursty chat (gamma gaps),
    here with two-point prompts: two new files under arrivals/ and
    lengths/, a mix and an entry; nothing edited."""
    root, bench = _checkout(tmp_path)
    (root / "benchmark" / "arrivals" / "gamma.py").write_text(GAMMA)
    (root / "benchmark" / "lengths" / "two_point.py").write_text(TWO_POINT)
    mix = harness.load_json(os.path.join(harness.BENCH, "traffic",
                                         "chat.json"))
    mix.update(arrivals="gamma", cv=3.0,
               prompt={"dist": "two_point", "min": 8, "max": 64,
                       "share": 0.25})
    (root / "benchmark" / "traffic" / "chat_burst.json").write_text(
        json.dumps(mix))
    bench["workloads"].append({"name": "gpt2_w4.chat_burst",
                               "config": "gpt2_small_w4",
                               "traffic": "chat_burst", "chips": 1,
                               "why": "bursty arrivals"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.Cell.find("gpt2_w4.chat_burst", str(root))
    from benchmark.common import traffic
    reqs = traffic.requests(c.mix, 3, 50257, 60.0, c.bench)
    gaps = np.diff([0.0] + [r.due for r in reqs])
    cv = float(np.std(gaps) / np.mean(gaps))
    assert 2.0 < cv < 4.0, cv                  # bursty: Poisson reads 1
    assert {r.prompt.size for r in reqs} == {8, 64}
    record, checks, correct = tiny.run(tiny.shrink(c), seconds=0.5)
    assert correct and record.attempted > 0, checks


def test_a_new_loop_is_a_file(tmp_path):
    """A mix whose ``kind`` names a loop file that no existing file
    knows: the harness drives the cell through it."""
    root, bench = _checkout(tmp_path)
    loops = root / "benchmark" / "loops"
    src = (loops / "image_batches.py").read_text()
    (loops / "image_batches_copy.py").write_text(
        src + "\nWARMED = []\n_warm = warm\n\n\n"
        "def warm(system, cell, seed, seconds):\n"
        "    WARMED.append(cell.name)\n"
        "    return _warm(system, cell, seed, seconds)\n")
    mix = harness.load_json(os.path.join(harness.BENCH, "traffic",
                                         "offline.json"))
    mix["kind"] = "image_batches_copy"
    (root / "benchmark" / "traffic" / "offline_copy.json").write_text(
        json.dumps(mix))
    bench["workloads"].append({"name": "vit_int8.offline_copy",
                               "config": "vit_base_int8",
                               "traffic": "offline_copy", "chips": 1,
                               "why": "the offline mix through a new loop"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.Cell.find("vit_int8.offline_copy", str(root))
    record, checks, correct = tiny.run(tiny.shrink(c), seconds=0.3)
    assert c.loop.WARMED == ["vit_int8.offline_copy"]
    assert correct and record.attempted > 0, checks
