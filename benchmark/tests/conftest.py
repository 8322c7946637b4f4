"""CPU tests of the benchmark (``python -m pytest benchmark/tests``), and
one test of the controls on the card, marked ``card``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card_absent():
    """A skip where a card is present: the test is of running without."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
