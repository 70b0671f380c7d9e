"""Tests of the benchmark (``benchmark/``). They run on the CPU at the
size of ``mini.py``; a test marked ``card`` needs an NVIDIA card and skips
elsewhere, which its ``card`` fixture decides when the test runs."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (runs the benchmark there)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu_threads():
    """Torch on two threads, as several test workers share the host."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
