"""The benchmark's own tests: ``python3 -m pytest portbench/tests``.

Tests that need a CUDA card carry the ``cuda`` marker and take the
``cuda_card`` fixture, which skips them without one (decided when the test
runs, never at import)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the program's kernels have no CPU "
                    "mode at the cells' sizes)")
    return torch.device("cuda", 0)
