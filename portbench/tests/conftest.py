"""CPU tests of the benchmark, run from the checkout's root:

    python3 -m pytest portbench/tests -q

Tests that need the card carry the ``gpu`` marker and skip, inside a
fixture, where no card is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs a cell of the benchmark on the card; skipped "
        "where torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
