"""The benchmark's own tests: `python -m pytest perfbench/tests -q` from the
root of the checkout. Tests marked `card` need a CUDA device and skip
without one (decided in the `card` fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda")
