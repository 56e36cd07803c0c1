"""Tests of the benchmark harness (not collected by the repository's
suite; run them with ``python -m pytest h100_bench/tests``).  Tests marked
``gpu`` need a CUDA device and skip without one, deciding inside the
test."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips "
                                       "without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
