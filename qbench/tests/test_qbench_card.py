"""Each cell through qbench/run.py on the card, a short window each:
the result line, correct. Skips without a card:

    python -m pytest qbench/tests/test_qbench_card.py -m gpu -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from qbench_cells import CELLS
from qbench import harness


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_card(card, cell):
    r = subprocess.run([sys.executable, "qbench/run.py", "--workload", cell,
                        "--seed", str(2**31 + 99), "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=harness.REPO, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().split("\n")[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(card)
    names = {m["name"] for m in harness.find_cell(cell).end_to_end}
    assert set(out["metrics"]) == names
