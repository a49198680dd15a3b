"""Shared fixtures of the benchmark's CPU tests: cells cut to a size the
CPU runs in seconds (the plain torch twins stand in for the kernels)."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = {"step": {"n_ensembles": 2, "n_frames": 1, "distinct": 2},
        "decode": {"n_frames": 8, "batch_frames": 4}}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name, withdrawn=True)
    cell.traffic.update(TINY[cell.driver])
    return cell


def run_tiny(cell: harness.Cell, seconds: float = 0.0, trace: bool = False, seed: int = 2 ** 31 + 17):
    return harness.driver_module(cell).run(cell, seed, seconds, trace, "cpu", time.perf_counter())


@pytest.fixture
def card():
    """Skips where torch sees no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch sees no CUDA device")
    return torch.device("cuda")
