"""The trained copy-task GPT: the decode and serving accuracy oracle (port
of ``numpy_quant_tpu/models/text_fixture.py``).

A compact GPT-2 (2 layers, hidden 128, 4 heads, vocabulary 50) was trained
on the token-copy language: a sample is ``s + [SEP] + s`` with ``s`` 12
tokens drawn uniformly from the 48 data tokens, so a working model greedy
decodes ``s`` again after the separator, with large logit margins. A
quantized configuration that damages the model shows as copy errors.

The weights are data of the JAX package (``gpt_trained.npz``, float16, in
HuggingFace's ``GPT2LMHeadModel`` key names) and are read where they lie;
the port builds the graphs with its own ``models/gpt.py`` builders.
:func:`make_copy_batch` draws the same sequences as the JAX package's from
the same ``numpy.random.Generator`` state. Retraining is not ported: the
oracles need only the committed weights.
"""
from __future__ import annotations

import os

import numpy as np

from .fixtures import FIXTURE_DIR, load_weights
from .gpt import gpt_causal_lm, gpt_decode_step, gpt_prefill

WEIGHTS_PATH = os.path.join(FIXTURE_DIR, "gpt_trained.npz")

VOCAB = 50          # 0..47 data tokens, 48 = SEP, 49 unused (pad)
SEP = 48
COPY_LEN = 12       # length of the copied segment s
SEQ_LEN = 2 * COPY_LEN + 1   # s + SEP + s
N_POSITIONS = 32

# the fixture's GPT2Config fields (the rest: GPT2_SMALL's)
FIXTURE_CONFIG = {"vocab_size": VOCAB, "n_positions": N_POSITIONS,
                  "n_embd": 128, "n_layer": 2, "n_head": 4}


def make_copy_batch(rng: np.random.Generator, n: int,
                    copy_len: int = COPY_LEN) -> np.ndarray:
    """n copy-language sequences [n, 2 copy_len + 1] int64:
    ``s + [SEP] + s`` with s uniform over the data tokens."""
    s = rng.integers(0, SEP, size=(n, copy_len))
    sep = np.full((n, 1), SEP)
    return np.concatenate([s, sep, s], axis=1).astype(np.int64)


def make_prompts(rng: np.random.Generator, n: int,
                 copy_len: int = COPY_LEN):
    """(prompts [n, copy_len + 1], expected [n, copy_len]): the prompt is
    ``s + [SEP]``; a working model greedy-decodes ``s``."""
    seqs = make_copy_batch(rng, n, copy_len)
    return seqs[:, :copy_len + 1], seqs[:, copy_len + 1:]


def trained_gpt_weights() -> dict[str, np.ndarray]:
    """The committed state dict, widened to float32."""
    return load_weights(WEIGHTS_PATH)


def trained_gpt_onnx(batch_size: int = 1, seq_len: int = SEQ_LEN):
    """The full-sequence causal graph of the fixture (gpt_causal_lm)."""
    return gpt_causal_lm(trained_gpt_weights(), FIXTURE_CONFIG,
                         batch_size=batch_size, seq_len=seq_len)


def trained_gpt_decode_onnx(batch_size: int = 1,
                            max_len: int = SEQ_LEN - 1):
    """The KV-cache decode-step graph of the fixture (gpt_decode_step)."""
    return gpt_decode_step(trained_gpt_weights(), FIXTURE_CONFIG,
                           batch_size=batch_size, max_len=max_len)


def trained_gpt_prefill_onnx(prefill_len: int):
    """The prefill graph of the fixture (gpt_prefill), for the
    continuous-batching engine's admission."""
    return gpt_prefill(trained_gpt_weights(), FIXTURE_CONFIG,
                       prefill_len=prefill_len)


def copy_accuracy(generated: np.ndarray, expected: np.ndarray) -> float:
    """Fraction of generated tokens matching the copy target."""
    generated = np.asarray(generated)[..., :expected.shape[-1]]
    return float((generated == expected).mean())
