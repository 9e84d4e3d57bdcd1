"""Per-value parity harness (port of ``numpy_quant_tpu/utils/parity.py``):
every intermediate value of one recorded forward as a host array, and a
per-value comparison of two such records."""
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
