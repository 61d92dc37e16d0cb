"""Pytest settings of the benchmark's own tests (``mpcbench/tests``).

``card``: the test needs an NVIDIA card and skips without one. Whether a
card is there is decided inside the ``card`` fixture, never while a module
is imported, so that every worker collects the same tests."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one (run on "
        "the card with: python3 -m pytest mpcbench/tests -m card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control and the card's path run "
                    "on the card only")
    return torch.device("cuda")
