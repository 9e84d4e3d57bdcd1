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
from the port's own ``models/gpt.py::gpt_causal_lm``; :func:`train_fixture`
trains one anew on the port's float walk (``train.py``).
"""
from __future__ import annotations

import os

import numpy as np

from .fixtures import FIXTURE_DIR, load_weights
from .gpt import gpt_causal_lm, random_gpt2_weights

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


def train_fixture(steps: int = 8000, batch: int = 256, lr: float = 1e-3,
                  seed: int = 0, path: str | None = None,
                  init: dict | None = None, device=None,
                  history: list | None = None) -> float:
    """Train the running-modular-sum GPT (the JAX package's
    ``train_fixture``: AdamW with no weight decay, cosine decay over
    ``steps``, the loss on the sum positions only, ``GPT2Config``'s dropout
    while training) through the port's float walk, from ``init`` (default:
    ``random_gpt2_weights`` at ``seed``) on ``device``. The weights are
    rounded to float16 and the held-out sum accuracy (1,024 sequences from
    ``seed + 1``) measured on exactly those; written to ``path`` when
    given. Each step's loss goes to ``history`` when given. Returns the
    held-out sum accuracy."""
    import torch

    from .. import config as port_config
    from ..train import GraphTrainer, gpt_dropout_sites, lm_loss, train
    dev = port_config.resolve_device(device)
    if init is None:
        init = random_gpt2_weights(MODSUM_CONFIG, seed=seed)
    trainer = GraphTrainer(
        lambda w: gpt_causal_lm(w, MODSUM_CONFIG, batch_size=batch,
                                seq_len=SEQ_LEN), init, dev,
        embed="transformer.wte.weight",
        dropout=gpt_dropout_sites(MODSUM_CONFIG["n_layer"]),
        seed=seed)
    rng = np.random.default_rng(seed)

    def data(step):
        seqs = make_modsum_batch(rng, batch)
        labels = seqs.copy()
        labels[:, 0::2] = -100          # only the sums are targets
        return [seqs], labels

    opt = torch.optim.AdamW(list(trainer.params.values()), lr=lr,
                            weight_decay=0.0)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps)
    state = train(trainer, steps, data,
                  lambda outs, labels: lm_loss(outs[0], labels), opt,
                  sched, history=history)
    if "lm_head.weight" in state:
        state["lm_head.weight"] = state["transformer.wte.weight"]
    stored = {k: v.astype(np.float16) for k, v in state.items()}
    seqs = make_modsum_batch(np.random.default_rng(seed + 1), 1024)
    acc = modsum_accuracy(_logits(stored, seqs, dev), seqs)
    if path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **stored)
    return acc


def _logits(weights: dict, seqs: np.ndarray, device) -> np.ndarray:
    """The float graph's logits over ``seqs``, one eager walk."""
    import torch

    from .. import config as port_config
    from ..model import Model
    w = {k: np.asarray(v, np.float32) for k, v in weights.items()}
    proto = gpt_causal_lm(w, MODSUM_CONFIG, batch_size=len(seqs),
                          seq_len=seqs.shape[1])
    model = Model.from_onnx(proto, device=device)
    with port_config.eager_forward(), torch.inference_mode():
        return model([proto._wte[seqs]])[0]
