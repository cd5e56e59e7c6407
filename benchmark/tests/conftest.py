"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
repository's root on the path, so that ``benchmark`` and the port import,
and one torch thread for the small CPU grids."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
