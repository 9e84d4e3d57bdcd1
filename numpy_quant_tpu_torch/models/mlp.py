"""The reference's MLP classifier and its data.

``mlp.onnx`` is the source paper's two-layer MLP (Gemm -> Relu -> Gemm ->
Sigmoid over 2-D points, 2 classes), byte for byte the file the JAX
package and the reference test with; ``two_circles`` makes the two
concentric circles it classifies, as the reference test draws them with
``sklearn.datasets.make_circles(1000, noise=0.03, random_state=3)``,
with numpy alone.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import onnx

MLP_PATH = Path(__file__).with_name("mlp.onnx")


def load_mlp() -> onnx.ModelProto:
    return onnx.load(MLP_PATH)


def two_circles(n_samples: int = 1000, noise: float = 0.03, seed: int = 3,
                factor: float = 0.8) -> tuple[np.ndarray, np.ndarray]:
    """(points float32 [n, 2], labels int [n]): an outer circle of radius
    1 (label 0) and an inner one of radius ``factor`` (label 1), shuffled,
    plus Gaussian noise -- make_circles' steps on a RandomState(seed)."""
    n_out = n_samples // 2
    n_in = n_samples - n_out
    t_out = np.linspace(0, 2 * np.pi, n_out, endpoint=False)
    t_in = np.linspace(0, 2 * np.pi, n_in, endpoint=False)
    x = np.vstack([np.append(np.cos(t_out), np.cos(t_in) * factor),
                   np.append(np.sin(t_out), np.sin(t_in) * factor)]).T
    y = np.hstack([np.zeros(n_out, dtype=np.intp),
                   np.ones(n_in, dtype=np.intp)])
    rs = np.random.RandomState(seed)
    order = np.arange(n_samples)
    rs.shuffle(order)
    x, y = x[order], y[order]
    x = x + rs.normal(scale=noise, size=x.shape)
    return x.astype(np.float32), y
