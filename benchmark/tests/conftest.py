"""Shared pieces of the benchmark's tests: the repository's root on the
path, small traffic sizes for the CPU, and the card fixture."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Sizes a CPU test holds: the cells' own configurations and mixes, cut.
TINY = {"width": 16, "height": 8, "ref_block": 64, "trace_units": 2,
        "trace_units_host": 2, "check_frames": 3}
TINY_DEEP = dict(TINY, bounces=12)
CELLS = ("cornell.train", "reference.frames", "cornell.frames",
         "reference.train")


def tiny(cell):
    return TINY_DEEP if cell == "reference.frames" else TINY


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (benchmark/run.py runs the cells "
                    "on one)")
    return torch.device("cuda")
