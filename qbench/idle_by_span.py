"""One traced window of a cell, with what its result line does not
carry: the idle inside each ``<query>.execute`` named by the program's
innermost span (``spans.idle_by_program_span``), the share of each
query's execute idle that a span names, and the device's events a query
by kind (kernels, copies, memsets).

    python qbench/idle_by_span.py --workload <cell> --seed <n> \\
        --seconds <s>

from the root of a checkout, on a CUDA card. Prints one JSON line: the
traced run's correct, metrics and breakdown, the window's queries, ``idle`` (the
labels, largest first), ``execute_idle`` and ``named_share`` by query,
and ``device_per_query``. A program without spans gives the labels of
the result line's ``idle_gaps`` and a named share of 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from qbench import harness, spans, trace  # noqa: E402


def kind(name: str) -> str:
    """A device event's kind by its name: "copy", "memset" or "kernel"."""
    low = name.lower()
    return ("copy" if low.startswith("memcpy")
            else "memset" if low.startswith("memset") else "kernel")


def summary(events, window: trace.Window) -> dict:
    """What the result line lacks, from the window's profile events and
    its Window."""
    idle = spans.idle_by_program_span(events)
    total, named = defaultdict(float), defaultdict(float)
    for label, secs in idle.items():
        q, _, below = label.partition("/")
        if q.endswith(".execute"):
            total[q] += secs
            named[q] += secs if below else 0.0
    per_kind = defaultdict(lambda: [0, 0.0])
    for name, s, e in window.device:
        per_kind[kind(name)][0] += 1
        per_kind[kind(name)][1] += e - s
    n = max(window.queries, 1)
    return {
        "queries": window.queries,
        "idle": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "execute_idle": dict(total),
        "named_share": {q: named[q] / total[q] for q in total if total[q]},
        "device_per_query": {k: {"events": c / n, "ms": t * 1e3 / n}
                             for k, (c, t) in sorted(per_kind.items())},
    }


def traced(cell: harness.Cell, seed: int, seconds: float,
           device: torch.device, t_start: float, log=None) -> dict:
    """One traced run of cell (harness.run) and the summary of its
    window."""
    got = {}
    read_profile = trace.read_profile

    def keep(prof, window):
        got["events"] = prof.profiler.kineto_results.events()
        got["window"] = read_profile(prof, window)
        return got["window"]

    trace.read_profile = keep
    try:
        out = harness.run(cell, seed, seconds, True, device, t_start, log)
    finally:
        trace.read_profile = read_profile
    return {"correct": out["correct"], "metrics": out["metrics"],
            "breakdown": out.get("breakdown"),
            **summary(got["events"], got["window"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qbench: idle_by_span needs a CUDA card", file=sys.stderr)
        return 2
    line = traced(harness.find_cell(args.workload), args.seed, args.seconds,
                  torch.device("cuda", 0), T_START)
    print(json.dumps({"workload": args.workload, "seed": args.seed, **line}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
