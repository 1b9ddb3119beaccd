"""The benchmark's own tests (run with `python -m pytest portbench/tests`
from the root of the repository). Tests that need a CUDA card carry the
`chip` marker and skip without one; the decision is taken in the `cuda`
fixture, never while a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")
