"""The reference's MLP classifier, its data and its builders.

``mlp.onnx`` is the source paper's two-layer MLP (Gemm -> Relu -> Gemm ->
Sigmoid over 2-D points, 2 classes), byte for byte the file the JAX
package and the reference test with; ``two_circles`` makes the two
concentric circles it classifies, as the reference test draws them with
``sklearn.datasets.make_circles(1000, noise=0.03, random_state=3)``,
with numpy alone.

``build_mlp_onnx``, ``get_torch_model`` and ``export_mlp`` port the JAX
package's builders (``numpy_quant_tpu/models/mlp.py``): the graph with the
torch exporter's names, and the 2 -> hidden -> 2 torch module trained on
``two_circles`` (the points sklearn's make_circles draws for the same
seed) with the same optimizer, loss and epochs.
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


def build_mlp_onnx(fc1_weight: np.ndarray, fc1_bias: np.ndarray,
                   fc2_weight: np.ndarray, fc2_bias: np.ndarray,
                   dynamic_batch: bool = True) -> onnx.ModelProto:
    """Gemm(transB)->Relu->Gemm(transB)->Sigmoid graph with the torch
    exporter's value and node names (``mlp.onnx``'s graph for its
    weights)."""
    batch = "batch_size" if dynamic_batch else 1
    inp = onnx.make_tensor_value_info("input", onnx.TensorProto.FLOAT,
                                      [batch, fc1_weight.shape[1]])
    out = onnx.make_tensor_value_info("output", onnx.TensorProto.FLOAT,
                                      [batch, fc2_weight.shape[0]])
    inits = [onnx.from_array(a.astype(np.float32), name) for a, name in (
        (fc1_weight, "fc1.weight"), (fc1_bias, "fc1.bias"),
        (fc2_weight, "fc2.weight"), (fc2_bias, "fc2.bias"))]
    nodes = [
        onnx.make_node("Gemm", ["input", "fc1.weight", "fc1.bias"],
                       ["/fc1/Gemm_output_0"], name="/fc1/Gemm",
                       alpha=1.0, beta=1.0, transB=1),
        onnx.make_node("Relu", ["/fc1/Gemm_output_0"],
                       ["/relu/Relu_output_0"], name="/relu/Relu"),
        onnx.make_node("Gemm",
                       ["/relu/Relu_output_0", "fc2.weight", "fc2.bias"],
                       ["/fc2/Gemm_output_0"], name="/fc2/Gemm",
                       alpha=1.0, beta=1.0, transB=1),
        onnx.make_node("Sigmoid", ["/fc2/Gemm_output_0"], ["output"],
                       name="/sigmoid/Sigmoid"),
    ]
    graph = onnx.make_graph(nodes, "main_graph", [inp], [out],
                            initializer=inits)
    return onnx.make_model(graph, producer_name="numpy-quant-tpu",
                           opset_imports=[onnx.make_opsetid("", 17)])


def get_torch_model(hidden_size: int = 5, n_samples: int = 1000,
                    epochs: int = 1500, seed: int = 1):
    """(module, training accuracy): the 2 -> hidden -> 2 MLP (Linear, ReLU,
    Linear, Sigmoid) trained on the CPU with Adam (lr 0.02) and BCE against
    one-hot labels of ``two_circles(n_samples, 0.03, seed)``, full batch,
    ``epochs`` steps, torch seeded with ``seed``."""
    import torch

    torch.manual_seed(seed)
    X, Y = two_circles(n_samples=n_samples, noise=0.03, seed=seed)
    X = torch.tensor(X, dtype=torch.float32)
    Y = torch.tensor(Y.astype(np.int64))
    Y1h = torch.nn.functional.one_hot(Y, 2).float()

    model = torch.nn.Sequential(
        torch.nn.Linear(2, hidden_size),
        torch.nn.ReLU(),
        torch.nn.Linear(hidden_size, 2),
        torch.nn.Sigmoid(),
    )
    opt = torch.optim.Adam(model.parameters(), lr=0.02)
    loss_fn = torch.nn.BCELoss()
    for _ in range(epochs):
        opt.zero_grad()
        loss = loss_fn(model(X), Y1h)
        loss.backward()
        opt.step()
    acc = (model(X).argmax(dim=1) == Y).float().mean().item()
    return model, acc


def export_mlp(path=None, seed: int = 1) -> onnx.ModelProto:
    """Train :func:`get_torch_model` at ``seed`` and build its graph; saved
    to ``path`` when given."""
    model, _ = get_torch_model(seed=seed)
    fc1, fc2 = model[0], model[2]
    onnx_model = build_mlp_onnx(
        fc1.weight.detach().numpy(), fc1.bias.detach().numpy(),
        fc2.weight.detach().numpy(), fc2.bias.detach().numpy())
    if path is not None:
        onnx.save(onnx_model, path)
    return onnx_model
