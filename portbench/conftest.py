"""The benchmark's tests import the port from the checkout's `src`, as
`run.py` does, and run their CPU models on two threads, so that they take
little from tests that time themselves in other workers."""

import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)
