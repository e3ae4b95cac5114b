"""Shared pieces of the benchmark's own tests: the cells at small sizes
on the CPU. Run from the root of the repository:

    python -m pytest qbench/tests -q
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from qbench import harness  # noqa: E402

ROWS = 10_000               # every configuration's small size
CELLS = [w["name"] for w in harness.load_json(
    harness.REPO / "BENCHMARK.json")["workloads"]]
SEED = 2**33 + 5            # a seed wider than 32 bits


def small_cell(name: str) -> harness.Cell:
    cell = harness.find_cell(name)
    cell.config = harness.scaled(cell.config, ROWS)
    return cell


def run_small(name: str, traced: bool = False, seconds: float = 0.2,
              seed: int = SEED) -> dict:
    """One run of the cell at its small size on the CPU."""
    return harness.run(small_cell(name), seed, seconds, traced,
                       torch.device("cpu"), time.perf_counter(),
                       log=lambda msg: None)
