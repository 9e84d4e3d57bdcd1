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
the same ``numpy.random.Generator`` state. :func:`train_fixture` trains
one anew on the port's float walk (``train.py``).
"""
from __future__ import annotations

import os

import numpy as np

from .fixtures import FIXTURE_DIR, load_weights
from .gpt import (gpt_causal_lm, gpt_decode_step, gpt_prefill,
                  random_gpt2_weights)

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


def train_fixture(steps: int = 3000, batch: int = 128, lr: float = 1e-3,
                  seed: int = 0, path: str | None = None,
                  init: dict | None = None, device=None,
                  history: list | None = None) -> float:
    """Train the copy-language GPT (the JAX package's ``train_fixture``:
    AdamW, cosine decay over ``steps``, the loss on every next token,
    ``GPT2Config``'s dropout while training) through the port's float
    walk, from ``init`` (default: ``random_gpt2_weights`` at ``seed``) on
    ``device``. The weights are rounded to float16 and the held-out copy
    accuracy (512 sequences from ``seed + 1``) measured on exactly those;
    written to ``path`` when given. Each step's loss goes to ``history``
    when given. Returns the held-out next-token copy accuracy."""
    import torch

    from .. import config as port_config
    from ..model import Model
    from ..train import GraphTrainer, gpt_dropout_sites, lm_loss, train
    dev = port_config.resolve_device(device)
    if init is None:
        init = random_gpt2_weights(FIXTURE_CONFIG, seed=seed)
    trainer = GraphTrainer(
        lambda w: gpt_causal_lm(w, FIXTURE_CONFIG, batch_size=batch,
                                seq_len=SEQ_LEN), init, dev,
        embed="transformer.wte.weight",
        dropout=gpt_dropout_sites(FIXTURE_CONFIG["n_layer"]),
        seed=seed)
    rng = np.random.default_rng(seed)

    def data(step):
        seqs = make_copy_batch(rng, batch)
        return [seqs], seqs

    opt = torch.optim.AdamW(list(trainer.params.values()), lr=lr)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps)
    state = train(trainer, steps, data,
                  lambda outs, labels: lm_loss(outs[0], labels), opt,
                  sched, history=history)
    if "lm_head.weight" in state:
        state["lm_head.weight"] = state["transformer.wte.weight"]
    stored = {k: v.astype(np.float16) for k, v in state.items()}
    seqs = make_copy_batch(np.random.default_rng(seed + 1), 512)
    proto = gpt_causal_lm({k: v.astype(np.float32) for k, v in
                           stored.items()}, FIXTURE_CONFIG,
                          batch_size=len(seqs), seq_len=SEQ_LEN)
    model = Model.from_onnx(proto, device=dev)
    with port_config.eager_forward(), torch.inference_mode():
        logits = model([proto._wte[seqs]])[0][:, COPY_LEN:-1]
    acc = float((logits.argmax(-1) == seqs[:, COPY_LEN + 1:]).mean())
    if path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **stored)
    return acc
