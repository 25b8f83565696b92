"""The benchmark's own tests (run: ``python -m pytest gpubench/tests``
from the root of the checkout; on the card the ``card`` tests run too).

``card`` marks a test that needs a CUDA device; the ``card`` fixture
decides inside the test, never at import, and skips without one."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
