"""The benchmark's own tests: CPU tests, and card tests marked `cuda`
that skip where no CUDA card is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips when none is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
