"""The one traffic generator: seeded, repeatable, the same work for every
seed in another order."""
import numpy as np
import torch

from benchmark.common import traffic
from benchmark.common.harness import BENCH, load_json

CHAT = load_json(f"{BENCH}/traffic/chat.json")
BATCH = load_json(f"{BENCH}/traffic/batch.json")


def _key(reqs):
    return [(r.due, r.prompt.tolist(), r.max_new) for r in reqs]


def test_requests_repeat_exactly():
    for mix in (CHAT, BATCH):
        a = traffic.requests(mix, 2 ** 33 + 5, 50257, 10.0)
        b = traffic.requests(mix, 2 ** 33 + 5, 50257, 10.0)
        assert _key(a) == _key(b)
        c = traffic.requests(mix, 2 ** 33 + 6, 50257, 10.0)
        assert _key(a) != _key(c)


def _work(reqs):
    """The multiset of the run's work: arrival gaps, (prompt, output)
    sizes."""
    due = [0.0] + [r.due for r in reqs]
    gaps = sorted(round(b - a, 9) for a, b in zip(due, due[1:]))
    return gaps, sorted((r.prompt.size, r.max_new) for r in reqs)


def test_every_seed_asks_for_the_same_work_in_another_order():
    for mix in (CHAT, BATCH):
        a = traffic.requests(mix, 1, 50257, 10.0)
        b = traffic.requests(mix, 2 ** 31 + 11, 50257, 10.0)
        assert _work(a) == _work(b)
        assert [(r.prompt.size, r.max_new) for r in a] != \
            [(r.prompt.size, r.max_new) for r in b]
    # each mix is ordered in blocks: every block holds the same sizes
    # (and the same arrival gaps) whatever the seed
    for mix in (CHAT, BATCH):
        block = mix["order_block"]
        a = traffic.requests(mix, 1, 50257, 10.0)
        b = traffic.requests(mix, 5, 50257, 10.0)
        for i in range(0, len(a), block):
            assert _work(a[i:i + block])[1] == _work(b[i:i + block])[1]
            if mix["load"] == "open":
                ga = np.diff([a[i - 1].due if i else 0.0]
                             + [r.due for r in a[i:i + block]])
                gb = np.diff([b[i - 1].due if i else 0.0]
                             + [r.due for r in b[i:i + block]])
                assert np.allclose(sorted(ga), sorted(gb))


def _within(reqs, mix):
    p, o = mix["prompt"], mix["output"]
    return all(p["min"] <= r.prompt.size <= p["max"]
               and o["min"] <= r.max_new <= o["max"] for r in reqs)


def test_lengths_and_arrivals_within_the_mix():
    reqs = traffic.requests(CHAT, 7, 50257, 10.0)
    assert _within(reqs, CHAT)
    assert all(0 < r.due < 10.0 for r in reqs)
    assert all(a.due < b.due for a, b in zip(reqs, reqs[1:]))
    # Poisson at the mix's rate: the count within 5 standard deviations
    n, mean = len(reqs), CHAT["rate"] * 10.0
    assert abs(n - mean) < 5 * mean ** 0.5
    # the medians the mix names, within a tenth
    for part, key in (("prompt", "size"), ("output", "max_new")):
        got = np.median([r.prompt.size if key == "size" else r.max_new
                         for r in reqs])
        assert abs(got - CHAT[part]["median"]) <= 0.1 * \
            CHAT[part]["median"] + 1
    back = traffic.requests(BATCH, 7, 50257, 10.0)
    assert len(back) == BATCH["pool"]
    assert _within(back, BATCH)
    assert all(0 <= int(r.prompt.min()) and int(r.prompt.max()) < 50257
               for r in back)


def test_images_repeat_exactly():
    mix = {"distinct": 2, "batch": 3, "image_std": 0.5}
    a = traffic.images(mix, 99, (3, 8, 8), torch.device("cpu"))
    b = traffic.images(mix, 99, (3, 8, 8), torch.device("cpu"))
    c = traffic.images(mix, 99, (3, 8, 8), torch.device("cpu"),
                       stream="calibration")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 3, 3, 8, 8)


def test_streams_differ_and_take_large_seeds():
    seeds = {traffic.stream_seed(2 ** 40 + 3, s)
             for s in ("weights", "images", "requests", "check")}
    assert len(seeds) == 4
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert traffic.stream_seed(-5, "x") == traffic.stream_seed(
        2 ** 64 - 5, "x")
    rng = np.random.default_rng(0)
    assert set(traffic.lengths({"dist": "fixed", "value": 3}, 4, rng)) == {3}

