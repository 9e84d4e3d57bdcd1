"""The benchmark's own tests. Tests that need a CUDA card take the
``card`` fixture, which skips them where there is none (decided when the
test runs, never at import)."""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
    if os.environ.get("PYTEST_XDIST_WORKER"):
        # the tiny runs time short windows on the CPU: several workers of
        # one thread per core each would starve them
        import torch
        torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
