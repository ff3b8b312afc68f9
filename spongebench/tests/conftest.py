"""Tests of the benchmark harness.  Run from the repository root:

    python -m pytest spongebench/tests -q

Tests marked ``card`` need a CUDA device and skip without one; the
decision is taken inside the test (the ``cuda`` fixture), never while a
module is imported.
"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
