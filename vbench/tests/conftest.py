"""Fixtures of the benchmark's CPU tests: tiny widths for whole runs on the
CPU (the port's plain PyTorch path), and the ``card`` marker."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# widths small enough for a whole run on the CPU in a few seconds
TINY = dict(total_vectors=1500, dim=32, M=8, R=16, R_slack=20, L_build=40, L_search=40,
            bootstrap_sample=200, refine_sample=1000, max_vectors_per_partition=2000)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def tiny():
    return dict(TINY)


@pytest.fixture
def few_threads():
    """Two CPU threads for a whole run, restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card only")
