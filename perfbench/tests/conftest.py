"""Settings of the benchmark's own tests (run from the repository root:
``python -m pytest perfbench/tests``). Tests that need the CUDA card carry
the ``cuda`` marker and decide inside their fixture whether to skip."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs the CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")
