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
"""
from __future__ import annotations

import os

import numpy as np

from .vit import vit_image_classifier

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
