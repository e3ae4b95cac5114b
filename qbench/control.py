"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed one precision lower than
the configuration states (float32 for float64), held to the reference
with the limits a run uses. Every cell's control has to come out not
correct; ``PERF.md`` keeps its readings, the upper ends of the limits.

    python qbench/control.py --workload <cell> --seeds 1 2 3

on the card, at the cell's own size
(``test_qbench_reference.test_control_is_not_correct`` runs it at 10,000
rows on the CPU). Prints one JSON line a seed: each compared number, its
limit, and whether the control passed them all.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from qbench import harness  # noqa: E402


def control_checks(cell: harness.Cell, seed: int, device) -> dict:
    """{"<query>.<number>": (reading, limit)} of the control's answers
    against the reference's, over the cell's tables made from seed, in
    the cell's blocks (``check_blocks``) as a run checks them."""
    tables = harness.make_tables(cell, seed, device)
    parts = harness.compare_all(
        cell, tables, lambda q, fn, t, b: None if fn is None
        else fn(t, fdtype=torch.float32))
    return harness.readings(cell, parts)[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = harness.find_cell(args.workload)
    for seed in args.seeds:
        checks = control_checks(cell, seed, torch.device("cuda", 0))
        passed = all(v <= lim for v, lim in checks.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": passed,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
