"""Per-value parity harness (port of ``numpy_quant_tpu/utils/parity.py``):
every intermediate value of one recorded forward as a host array, a
per-value comparison of two such records, and the named-values record
the PTQ passes read (:func:`record_values`)."""
from __future__ import annotations

import numpy as np
import torch


def _host(data) -> np.ndarray:
    """A recorded payload (a device tensor, bf16 widened to float32, or a
    host array) as numpy."""
    if isinstance(data, torch.Tensor):
        if data.dtype == torch.bfloat16:
            data = data.to(torch.float32)
        return data.cpu().numpy()
    return np.asarray(data)


def record_all_values(model, inputs: list) -> dict[str, np.ndarray]:
    """Run the model eagerly (``record=True``) and return {value name:
    ndarray} for every value in the graph (Variables and Constants);
    quantized values are dequantized, as in the JAX package."""
    model(inputs, record=True)
    out = {}
    for value in model.values:
        if value.data is None:
            continue
        data = value.data
        arr = data.dequantize().data if hasattr(data, "dequantize") \
            else data.data
        out[value.name] = _host(arr)
    return out


def record_values(model, inputs: list, names, keep=None) -> dict:
    """{name: kept tensor} for the values named in ``names``, from one
    eager walk of ``model`` over ``inputs``: each value dequantized to a
    float32 tensor on the model's device as it is made and passed through
    ``keep(name, tensor)`` (default: kept whole). Unlike
    :func:`record_all_values` nothing else is held or copied to the host;
    the walk frees every other value after its last use. Runs under
    ``torch.no_grad`` (not inference mode), so what it keeps can enter an
    autograd graph."""
    from ..tensor import FTensor, QTensor

    names = set(names)
    out = {}

    def visit(name, tensor):
        if name not in names:
            return
        if isinstance(tensor, QTensor):
            tensor = tensor.dequantize()
        if not isinstance(tensor, FTensor):
            return
        d = tensor.data.to(torch.float32)
        out[name] = d if keep is None else keep(name, d)

    with torch.no_grad():
        input_tensors = {v.name: model._wrap_input(a, v)
                         for a, v in zip(inputs, model.inputs)}
        model._forward(input_tensors, visit=visit)
    return out


def compare_all_values(actual: dict[str, np.ndarray],
                       desired: dict[str, np.ndarray],
                       decimal: int = 4, skip: tuple = ()) -> None:
    """Assert mean elementwise L1 ~= 0 (to ``decimal`` places) for every
    shared value name."""
    shared = sorted(set(actual) & set(desired))
    assert shared, "no shared value names to compare"
    for name in shared:
        if name in skip:
            continue
        a, d = actual[name], desired[name]
        # broadcast-compare: rank-0 Gather outputs against rank-preserving
        # ones differ only in rank
        try:
            diff = a.astype(np.float64) - d.astype(np.float64)
        except ValueError:
            raise AssertionError(f"{name}: shape {a.shape} != {d.shape}")
        mean_l1 = np.mean(np.abs(diff))
        np.testing.assert_almost_equal(
            mean_l1, 0.0, decimal=decimal,
            err_msg=f"Mean elementwise l1 norm for {name}: {mean_l1}")
