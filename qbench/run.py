"""The benchmark of aquery2_tpu_torch: one run of one cell.

    python qbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints progress and the compared numbers
beside their limits on standard error, and as the last line of standard
output one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device (and
with --trace 1 the breakdown), then the compared numbers. Exits non-zero,
with no result, where no CUDA card is there or fewer than the cell asks
for, and where JAX or the JAX package was loaded. A cell of one chip
runs in this process on cuda:0 (harness.py); a cell of N > 1 chips runs
as N ranks of one mesh session, one process and one card a rank, and
this process prints rank 0's result (ranks.py; exits non-zero, with no
result, where the ranks run past their deadline). The cells, their
configurations, queries and metrics are named in BENCHMARK.json and found
by name under qbench/ (see harness.py).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from qbench import harness, ranks  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    cell = harness.find_cell(args.workload)
    chips = cell.workload["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"qbench: {args.workload} needs {chips} CUDA card(s); "
              f"{cards} available", file=sys.stderr)
        return 2
    if chips == 1:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
        bad = harness.forbidden_modules()
    else:
        try:
            out, bad = ranks.run(cell, args.seed, args.seconds,
                                 bool(args.trace),
                                 [torch.device("cuda", r)
                                  for r in range(chips)], None, T_START)
        except ranks.WorldTimeout as exc:
            print(f"qbench: {exc}", file=sys.stderr)
            return 4
    if bad:
        print(f"qbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
