import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (run on the card with "
        "`python -m pytest -m cuda benchmark/tests`)")


@pytest.fixture
def card():
    """The card, decided when a test asks for it; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the card only")
    return "cuda"
