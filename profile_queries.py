#!/usr/bin/env python3
"""Where the time goes: one torch.profiler trace of each chip_smoke.py
query on one CUDA card.

    python3 profile_queries.py [--out DIR]

Loads the tables chip_smoke.py loads (h2o G1_1e7_1e1_0_0 with its dim
table, trades, G1_1e7_1e1_5_0) and, for each of its queries (the general
engine's of phase 5, the windows and FUNCTIONs of phase 7 and the
AGGREGATION FUNCTION bodies of phase 8 but u_ewma, whose 1.5e6 launches
a run are more than one trace should hold): one first run, the median
wall time of three warm runs (host clock around execute plus a
synchronize, as chip_smoke.py times them), then one profiled run. In the
profiled run, "device ms" is the union of the intervals of the device
events (kernels, copies, memsets) and idle = 1 - device ms / wall ms.
Prints one JSON line per query with its largest device items by name;
with --out, also writes each query's key_averages table into DIR.
Results are not checked here: chip_smoke.py does that.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as C
from aquery2_tpu_torch import connect
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.utils.datagen import h2o_dim, h2o_g1, trades


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_query(db, name: str, sql: str, out: Path | None) -> dict:
    _res, wall = C.timed_runs(db, sql, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        db.execute(sql)
        torch.cuda.synchronize()
    dev = [e for e in p.events() if e.device_type != DeviceType.CPU]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us()
    device = busy_us((e.time_range.start, e.time_range.end) for e in dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    row = {"query": name, "wall_ms": wall, "device_ms": device / 1e3,
           "idle": 1.0 - device / 1e3 / wall, "device_events": len(dev),
           "top_ms": [[k[:80], v / 1e3] for k, v in top]}
    if out is not None:
        (out / f"profile_{name}.txt").write_text(p.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="directory for the tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_queries: no CUDA device is available", file=sys.stderr)
        return 1
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    K.build()
    profile_phases_4_5(dev, args.out)
    profile_phase_7(dev, args.out)
    profile_phase_8(dev, args.out)
    return 0


def profile_phase_7(dev, out: Path | None) -> None:
    """Phase 7's windows and FUNCTIONs, on the tables it loads."""
    arrays, d = trades(C.ROWS, 100, 7)
    for name, queries in C.PHASE7:
        db = connect(device=dev)
        if name == "trades":
            C.load(db, "trades", arrays, dev, types={"stocksymbol": T.StrT},
                   dictionaries={"stocksymbol": d})
        else:
            C.load(db, "x", h2o_g1(C.ROWS, C.K_GROUPS, C.SEED,
                                   nas=5 if name == "nas" else 0), dev)
        db.execute(C.UDFCOV)
        db.execute(C.SCALAR_UDF)
        for q in queries:
            profile_query(db, q, C.WINDOW_QUERIES[q], out)


def profile_phase_8(dev, out: Path | None) -> None:
    """Phase 8's AGGREGATION FUNCTION bodies on x = G1_1e7_1e1_0_0."""
    db = connect(device=dev)
    C.load(db, "x", h2o_g1(C.ROWS, C.K_GROUPS, C.SEED), dev)
    db.execute(C.COVARIANCES2)
    db.execute(C.CLIPSUM)
    for q in ("u_cov2", "u_clip", "u_clip_where"):
        profile_query(db, q, C.UDF_QUERIES[q], out)


def profile_phases_4_5(dev, out: Path | None) -> None:
    """Phases 4 and 5's queries, on the tables they load."""
    db = connect(device=dev)
    C.load(db, "source", h2o_g1(C.ROWS, C.K_GROUPS, C.SEED), dev)
    C.load(db, "dim", h2o_dim(C.ROWS, C.K_GROUPS, C.SEED), dev)
    for q, sql in C.QUERIES.items():
        profile_query(db, q, sql, out)
    arrays, d = trades(C.ROWS, 100, 7)
    db = connect(device=dev)
    C.load(db, "trades", arrays, dev, types={"stocksymbol": T.StrT},
           dictionaries={"stocksymbol": d})
    for q, sql in {**C.TRADES, **C.general_queries(arrays)}.items():
        profile_query(db, q, sql, out)
    db = connect(device=dev)
    C.load(db, "source", h2o_g1(C.ROWS, C.K_GROUPS, C.SEED, nas=5), dev)
    for q in C.NAS_QUERIES + C.GENERAL_NAS:
        profile_query(db, q + "@5pct_NA", C.QUERIES[q], out)


if __name__ == "__main__":
    sys.exit(main())
