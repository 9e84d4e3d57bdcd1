"""The plain references against the program's CPU path at a tiny size:
the ViT's int8 logits agree to the last bit in float32, GPT-2's served
greedy tokens are the reference's best."""
import numpy as np
import torch

from benchmark.reference.gpt2_w4 import dequant_grouped, tf32
from benchmark.tests import tiny


def test_vit_reference_equals_the_program_in_float32():
    record, checks, correct = tiny.run(tiny.cell("vit_int8.offline"))
    assert correct
    assert checks[0][1] <= 1e-6
    assert record.attempted > 0


def test_gpt2_reference_picks_every_served_token():
    for name in ("gpt2_w4.chat", "gpt2_w4.batch"):
        # a window long enough that a loaded CPU finishes a backlog's
        # requests inside it
        record, checks, correct = tiny.run(tiny.cell(name), seconds=3.0)
        assert correct, (name, checks)
        assert checks[0][1] <= 1e-5
        served = sum(t.size - p.size for p, t in record.sample["requests"])
        assert served >= 100


def test_grouped_dequantization_by_hand():
    w = np.array([[1.0, -2.0], [0.5, 4.0], [-3.0, 1.0], [0.25, 0.1]],
                 np.float32)
    got = dequant_grouped(w, 4, 2)
    # groups of 2 rows: absmax [1, 4] then [3, 1]; scale 2 * absmax / 15
    s = np.float32(2.0) * np.array([[1.0, 4.0], [3.0, 1.0]],
                                   np.float32) / np.float32(15)
    q = np.rint(np.clip(w / np.repeat(s, 2, axis=0), -8, 7))
    np.testing.assert_array_equal(got, q * np.repeat(s, 2, axis=0))
    assert got[0, 0] == np.float32(7 * s[0, 0])   # 7.5 clips to 7


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, 1.0 + 2 * 2.0 ** -10, -3.0])
    assert torch.equal(tf32(x), want)
