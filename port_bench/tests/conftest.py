"""The benchmark's own tests: CPU-runnable at small sizes, and tests that
need a card (marked ``cuda``) which decide inside the test whether there
is one.  Run with ``python3 -m pytest port_bench/tests``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips with a reason where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, in
    the test, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch.cuda.is_available() is false")
    return "cuda"
