"""The benchmark's own tests (run them with ``python -m pytest
benchmark/tests``). They run on the CPU at tiny sizes; a test that needs
the card takes the ``card`` fixture and skips without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for path in (BENCH, BENCH.parent):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
