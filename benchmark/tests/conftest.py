"""The benchmark's tests: ``python -m pytest benchmark/tests -q`` from the
repository's root. Tests marked ``card`` need a CUDA device and skip
without one; on the card: ``python -m pytest benchmark/tests -q -m card``.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (the H100); skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's kernels have no CPU "
                    "mode at the cell's size")
    return torch.device("cuda", 0)
