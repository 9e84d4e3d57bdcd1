"""The trained modular-sum GPT fixture: the accuracy oracle that low-bit
weight rounding can fail (port of
``numpy_quant_tpu/models/modsum_fixture.py``).

A sample is ``x1 r1 x2 r2 ... xk rk`` with ``x_i`` uniform in [0, P) and
``r_i = (x_1 + ... + x_i) mod P``. Predicting ``r_i`` takes exact P-way
arithmetic over the whole prefix, so quantization noise in any layer
rotates the answer off its residue class and errors compound along the
sequence. A 4-layer GPT-2 (vocab 97, 24 positions, n_embd 128, 4 heads)
was trained on it; its float16 weights are committed in HuggingFace's
``GPT2LMHeadModel`` key names and read where they lie
(``numpy_quant_tpu/models/fixtures/modsum_trained.npz``). The graph comes
from the port's own ``models/gpt.py::gpt_causal_lm``.
"""
from __future__ import annotations

import os

import numpy as np

from .fixtures import FIXTURE_DIR, load_weights
from .gpt import gpt_causal_lm

WEIGHTS_PATH = os.path.join(FIXTURE_DIR, "modsum_trained.npz")

P = 97              # modulus; tokens 0..96 are both inputs and sums
VOCAB = P
K_TERMS = 12        # terms per sample
SEQ_LEN = 2 * K_TERMS            # x1 r1 ... xk rk
N_POSITIONS = SEQ_LEN

# HF GPT2Config fields of the fixture (GPT-2's defaults otherwise)
MODSUM_CONFIG = {"vocab_size": VOCAB, "n_positions": N_POSITIONS,
                 "n_embd": 128, "n_layer": 4, "n_head": 4,
                 "activation_function": "gelu"}


def make_modsum_batch(rng: np.random.Generator, n: int,
                      k: int = K_TERMS) -> np.ndarray:
    """n interleaved running-sum sequences [n, 2k] int64:
    ``x1 r1 x2 r2 ...`` with r_i the prefix sum mod P."""
    x = rng.integers(0, P, size=(n, k))
    r = np.cumsum(x, axis=1) % P
    seq = np.empty((n, 2 * k), dtype=np.int64)
    seq[:, 0::2] = x
    seq[:, 1::2] = r
    return seq


def modsum_accuracy(logits: np.ndarray, seqs: np.ndarray) -> float:
    """Teacher-forced accuracy at the learnable positions: logits[t]
    predicts token t+1, a running sum exactly when t is even."""
    logits = np.asarray(logits)
    preds = logits[:, 0::2, :].argmax(-1)      # predictions at x slots
    targets = np.asarray(seqs)[:, 1::2]        # the r_i tokens
    return float((preds == targets).mean())


def trained_modsum_weights() -> dict[str, np.ndarray]:
    return load_weights(WEIGHTS_PATH)


def trained_modsum_onnx(batch_size: int = 1, seq_len: int = SEQ_LEN):
    """Full-sequence causal graph of the trained fixture over
    ``inputs_embeds``; ``_wte`` on the proto embeds the ids."""
    return gpt_causal_lm(trained_modsum_weights(), MODSUM_CONFIG,
                         batch_size=batch_size, seq_len=seq_len)
