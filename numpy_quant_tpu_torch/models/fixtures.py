"""The trained ViT fixtures: task-level accuracy oracles (port of
``numpy_quant_tpu/models/fixtures.py``).

Two compact ViTs were trained on a procedural 8-class image task and
their weights committed to the repo in HuggingFace's
``ViTForImageClassification`` key names:

* ``vit_trained.npz`` -- 64x64 images, patch 8, hidden 128, 4 heads,
  MLP 256, 4 layers (float32);
* ``vit_base_trained.npz`` -- ViT-Base widths (224x224 images, patch 16,
  197 tokens, hidden 768, 12 heads, MLP 3072), 2 layers (float16 storage,
  widened to float32 on load).

Task: RGB gratings; class = color {R, G, B, Y} x orientation {horizontal,
vertical}. :func:`make_batch` draws the same images as the JAX package's
generator from the same ``numpy.random.Generator`` state, byte for byte.

The weight files are data of the JAX package and are read where they lie
(``numpy_quant_tpu/models/fixtures/``); the port builds the graphs with
its own ``models/vit.py`` builder, no ``transformers`` module involved.
:func:`train_fixture` and :func:`train_base_fixture` train such a fixture
anew on the port's own float walk (``train.py``) and write it only where
the caller says.
"""
from __future__ import annotations

import os

import numpy as np

from .vit import random_vit_weights, vit_image_classifier

FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "numpy_quant_tpu", "models", "fixtures")
WEIGHTS_PATH = os.path.join(FIXTURE_DIR, "vit_trained.npz")
BASE_WEIGHTS_PATH = os.path.join(FIXTURE_DIR, "vit_base_trained.npz")

N_CLASSES = 8
IMAGE_SIZE = 64
BASE_IMAGE_SIZE = 224

_COLORS = np.array([[1.0, 0.1, 0.1],    # R
                    [0.1, 1.0, 0.1],    # G
                    [0.2, 0.2, 1.0],    # B
                    [1.0, 0.9, 0.1]],   # Y
                   dtype=np.float32)

# HF ViTConfig fields of the two fixtures (the rest: VIT_BASE's defaults)
FIXTURE_CONFIG = {
    "image_size": IMAGE_SIZE, "patch_size": 8, "hidden_size": 128,
    "num_attention_heads": 4, "intermediate_size": 256,
    "num_hidden_layers": 4, "num_labels": N_CLASSES}
BASE_FIXTURE_CONFIG = {
    "image_size": BASE_IMAGE_SIZE, "patch_size": 16, "hidden_size": 768,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "num_hidden_layers": 2, "num_labels": N_CLASSES}


def make_batch(rng: np.random.Generator, n: int,
               image_size: int = IMAGE_SIZE):
    """n labelled grating images, NCHW float32, and their int64 labels."""
    labels = rng.integers(0, N_CLASSES, size=n)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    images = np.empty((n, 3, image_size, image_size), np.float32)
    for i, lab in enumerate(labels):
        color = _COLORS[lab % 4]
        horizontal = (lab // 4) == 0
        freq = rng.uniform(0.3, 0.9)
        phase = rng.uniform(0, 2 * np.pi)
        coord = yy if horizontal else xx
        grating = np.sin(freq * coord + phase).astype(np.float32)
        img = color[:, None, None] * grating[None]
        img += rng.normal(scale=0.25, size=img.shape).astype(np.float32)
        images[i] = img
    return images, labels.astype(np.int64)


def load_weights(path: str) -> dict[str, np.ndarray]:
    """A committed fixture's state dict as float32 arrays by HF key."""
    with np.load(path) as f:
        return {k: np.asarray(f[k], np.float32) for k in f.files}


def trained_vit_weights() -> dict[str, np.ndarray]:
    return load_weights(WEIGHTS_PATH)


def trained_vit_base_weights() -> dict[str, np.ndarray]:
    return load_weights(BASE_WEIGHTS_PATH)


def trained_vit_onnx(batch_size=None):
    """The small trained ViT's ONNX graph (``batch_size=None``: dynamic
    batch axis)."""
    return vit_image_classifier(trained_vit_weights(), FIXTURE_CONFIG,
                                batch_size=batch_size)


def trained_vit_base_onnx(batch_size=None):
    """The trained ViT-Base-width fixture's ONNX graph."""
    return vit_image_classifier(trained_vit_base_weights(),
                                BASE_FIXTURE_CONFIG, batch_size=batch_size)


def held_out_accuracy(weights: dict, config: dict, seed: int,
                       image_size: int, device) -> float:
    """Accuracy of the float graph of ``weights`` on 256 images drawn from
    ``seed + 1``, one eager walk."""
    import torch

    from .. import config as port_config
    from ..model import Model
    xh, yh = make_batch(np.random.default_rng(seed + 1), 256,
                        image_size=image_size)
    model = Model.from_onnx(vit_image_classifier(weights, config,
                                                 batch_size=256),
                            device=device)
    with port_config.eager_forward(), torch.inference_mode():
        logits = model([xh])[0]
    return float((logits.argmax(-1) == yh).mean())


def train_fixture(steps: int = 400, batch: int = 64, lr: float = 3e-4,
                  seed: int = 0, path: str | None = None,
                  config: dict | None = None,
                  image_size: int = IMAGE_SIZE, weight_dtype=np.float32,
                  init: dict | None = None, device=None,
                  history: list | None = None) -> float:
    """Train a fixture ViT on the grating task (the JAX package's
    ``train_fixture``: Adam, ``make_batch`` from
    ``np.random.default_rng(seed)``) through the port's float walk, from
    ``init`` (an HF-keyed state dict; default: ``random_vit_weights`` of
    the config at ``seed``) on ``device`` (CUDA unless given). The weights
    are rounded to ``weight_dtype`` first and the held-out accuracy (256
    images from ``seed + 1``) measured on exactly those; they are written
    to ``path`` as a compressed ``.npz`` when one is given. Each step's loss
    goes to ``history`` when given. Returns the held-out accuracy."""
    import torch
    import torch.nn.functional as F

    from .. import config as port_config
    from ..train import GraphTrainer, train
    cfg = FIXTURE_CONFIG if config is None else dict(config)
    dev = port_config.resolve_device(device)
    if init is None:
        init = random_vit_weights(cfg, seed=seed)
    trainer = GraphTrainer(
        lambda w: vit_image_classifier(w, cfg, batch_size=batch), init, dev)
    rng = np.random.default_rng(seed)

    def data(step):
        x, y = make_batch(rng, batch, image_size=image_size)
        return [x], y

    opt = torch.optim.Adam(list(trainer.params.values()), lr=lr)
    state = train(trainer, steps, data,
                  lambda outs, y: F.cross_entropy(outs[0], y), opt,
                  history=history)
    stored = {k: v.astype(weight_dtype) for k, v in state.items()}
    acc = held_out_accuracy({k: v.astype(np.float32)
                              for k, v in stored.items()}, cfg, seed,
                             image_size, dev)
    if path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **stored)
    return acc


def train_base_fixture(steps: int = 180, batch: int = 32, lr: float = 1e-4,
                       seed: int = 0, path: str | None = None,
                       init: dict | None = None, device=None,
                       history: list | None = None) -> float:
    """Train the ViT-Base-width fixture (float16-stored weights) as
    :func:`train_fixture` trains the small one."""
    return train_fixture(steps=steps, batch=batch, lr=lr, seed=seed,
                         path=path, config=BASE_FIXTURE_CONFIG,
                         image_size=BASE_IMAGE_SIZE,
                         weight_dtype=np.float16, init=init, device=device,
                         history=history)
