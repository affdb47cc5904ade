"""CPU tests of the benchmark.  A test marked ``card`` needs a CUDA device
and skips without one; the decision is made inside a fixture, never at
import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an H100); skips without one")


@pytest.fixture(autouse=True)
def _card_only(request):
    if request.node.get_closest_marker("card") is not None:
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: run on the card")
