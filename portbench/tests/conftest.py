"""Shared fixtures of the benchmark's CPU tests.

Run from the root of the checkout:

    python -m pytest -q portbench/tests

The tests that need the card are marked ``cuda`` and skip without one.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import spec  # noqa: E402

# a volume the CPU runs in about a second: 4 blocks of 24 planes, bt 2
# (8-plane halos), the codec's 4^3 blocks whole
TINY = {"shape": [96, 16, 16], "ndiv": 4, "bt": 2}


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name, **config)``: the cell ``name`` of BENCHMARK.json
    (its traffic, limits and reference) on the tiny volume."""

    def make(name, **config):
        cell = spec.cell(name)
        cell.config = {**cell.config, **TINY, **config}
        return cell

    return make


class HostDevice:
    """The CPU in the card's place (``card.Card``'s methods): the
    program's plain kernels, nothing to build, no peak to read."""

    platform = "cpu"
    device = "cpu"
    backend = "ref"

    def build(self, libraries):
        return {"build_s": 0.0, "built": []}

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak(self):
        return 0

    def free(self):
        pass

    def kind(self):
        return "cpu"

    def describe(self):
        return "cpu"


@pytest.fixture
def host_device():
    return HostDevice()


@pytest.fixture
def cuda_card():
    """Skip unless a CUDA card is present (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
