"""Tests of the benchmark itself: ``python -m pytest portbench/tests``
from the checkout's root.  Those marked ``cuda`` need the card and skip
without one; on the card: ``python3 -m pytest portbench/tests -m cuda``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.cuda.get_device_name(0)
