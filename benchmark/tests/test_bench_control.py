"""The check's control and its planted faults: each run of the harness,
the chip's look skipped and the timed path broken underneath (or run in
the next precision below the configuration's), must come out not
correct."""
import numpy as np
import pytest
import torch

from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["vit_int8.offline", "vit_int8.feed"])
def test_vit_control_w4a8_fails(cell):
    c = tiny.cell(cell)
    c.spec["quantize"] = c.spec["control"]["quantize"]
    _, checks, correct = tiny.run(c)
    assert not correct, checks


def test_gpt2_control_tf32_fails():
    """The reference in TF32, put in the program's place, judged as the
    check judges served tokens: its widest gap passes the limit. It need
    not decode: at each served position of greedy answers (the float32
    reference's own) the TF32 reference's first token is judged. Greedy
    decoding of random weights soon repeats itself, where no close call
    is left to flip, so this small size judges many short answers to
    random prompts over a wider vocabulary, at the published depth (the
    TF32 error grows with it)."""
    from benchmark.reference.gpt2_w4 import GPT2W4
    c = tiny.cell("gpt2_w4.batch")
    c.spec.update(vocab_size=16384, n_embd=256, n_layer=12)
    cpu = torch.device("cpu")
    ref = GPT2W4(c.config.weights(c.spec, 7, cpu), c.spec, cpu)
    rng = np.random.default_rng(7)
    requests = []
    for _ in range(1000):
        prompt = rng.integers(0, 16384, size=8).astype(np.int32)
        seq = prompt
        for _ in range(3):
            nxt = int(ref.logits(seq, rows=slice(-1, None)).argmax())
            seq = np.append(seq, np.int32(nxt))
        requests.append((prompt, seq))
    assert c.config.served_gaps(ref, requests) == 0.0
    gap = c.config.served_gaps(ref, requests, control=True)
    assert gap > c.spec["check"]["limit"], gap


@pytest.fixture
def plant(monkeypatch):
    return monkeypatch


def _vit_fault(plant, fault):
    """Breaks both ViT entry points: ``map_batches`` (logits [steps, B,
    labels]) and ``serve_ring`` (one [B, labels] per batch)."""
    from numpy_quant_tpu_torch import serving

    def spoil(logits):                        # [..., B, labels], in place
        if fault == "answer":                 # image 0's labels rolled
            n = logits.shape[-1]
            logits[..., 0, :] = logits[..., 0, [*range(1, n), 0]]
        elif fault == "half_batch":
            half = logits.shape[-2] // 2
            logits[..., half:2 * half, :] = logits[..., :half, :]

    real_map, real_ring = serving.map_batches, serving.serve_ring

    def map_batches(model, inputs, as_numpy=True):
        out = real_map(model, inputs, as_numpy)
        spoil(out[0])
        return out

    def serve_ring(model, batches, probe=True):
        outs = real_ring(model, batches, probe)
        for o in outs:
            spoil(o[0])
        return outs

    plant.setattr(serving, "map_batches", map_batches)
    plant.setattr(serving, "serve_ring", serve_ring)


@pytest.mark.parametrize("cell", ["vit_int8.offline", "vit_int8.feed"])
@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_vit_faults_fail(plant, cell, fault):
    _vit_fault(plant, fault)
    _, checks, correct = tiny.run(tiny.cell(cell))
    assert not correct, checks


def _gpt_fault(plant, fault):
    from numpy_quant_tpu_torch.utils import serving
    real_pick = serving.ContinuousBatcher._pick
    real_adv = serving.ContinuousBatcher._advance

    if fault == "token":
        def pick(self, row, step, sampling):
            nxt = real_pick(self, row, step, sampling)
            if step % 7 == 3:
                nxt = (nxt + 1) % row.shape[-1]
            return nxt
        plant.setattr(serving.ContinuousBatcher, "_pick", pick)
    elif fault == "state_unchanged":
        def advance(self, active, step, sampling):
            saved = [c.clone() for c in self._caches]
            done = real_adv(self, active, step, sampling)
            for c, s in zip(self._caches, saved):
                c.copy_(s)
            return done
        plant.setattr(serving.ContinuousBatcher, "_advance", advance)
    elif fault == "half_batch":
        def pick(self, row, step, sampling):
            nxt = real_pick(self, row, step, sampling)
            half = nxt.shape[0] // 2
            return torch.cat([nxt[:half], nxt[:nxt.shape[0] - half]])
        plant.setattr(serving.ContinuousBatcher, "_pick", pick)


@pytest.mark.parametrize("cell", ["gpt2_w4.chat", "gpt2_w4.batch"])
@pytest.mark.parametrize("fault", ["token", "state_unchanged", "half_batch"])
def test_gpt2_faults_fail(plant, cell, fault):
    _gpt_fault(plant, fault)
    _, checks, correct = tiny.run(tiny.cell(cell))
    assert not correct, checks
