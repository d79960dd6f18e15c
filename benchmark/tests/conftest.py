"""Settings of the benchmark's own tests (``python -m pytest
benchmark/tests``).  Tests marked ``card`` run only where CUDA has a
card; each decides inside a fixture, so every process collects the same
tests."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process: the cell runs on the card")
    return torch.cuda.device_count()
