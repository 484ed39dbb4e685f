"""Tests of the benchmark: `python -m pytest vobench/tests` from the root
of a checkout. The tests marked `cuda` need the card and skip without
one: `python -m pytest vobench/tests -m cuda` there."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels)")


@pytest.fixture
def card():
    """The card's device; skips the test where there is none (decided
    here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def small_run():
    """Test runs check `small.CHECK_BLOCKS` blocks and profile
    `small.TRACE_FRAMES` frames."""
    from vobench import run
    from vobench.tests import small

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run, "CHECK_BLOCKS", small.CHECK_BLOCKS)
        mp.setattr(run, "TRACE_FRAMES", small.TRACE_FRAMES)
        yield
