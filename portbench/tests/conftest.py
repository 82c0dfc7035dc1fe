"""The benchmark's own tests: ``python3 -m pytest portbench/tests`` from the
root of the checkout (``-m cuda`` on a machine with a card for the tests
marked ``cuda``).  JAX-free: nothing here imports JAX or the JAX package."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python3 -m pytest -m cuda portbench/tests)")
    return torch.device("cuda", 0)
