"""pytest settings of the benchmark's tests (python -m pytest benchmark/tests).

`card`: a test that needs a CUDA card.  Whether a card is there is decided
inside the `card` fixture, when the test runs, never while a module is
imported, so every worker collects the same tests."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100 (python -m pytest benchmark/tests -m card)")
    return torch.device("cuda", 0)
