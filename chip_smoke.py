#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aquery2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any mismatch raises; there is no fallback):
  1. identify the card (nvidia-smi name and power limit, torch, CUDA);
  2. build the CUDA kernels from aquery2_tpu_torch/csrc/, and print
     ptxas' registers, spills, stack and static shared memory of each;
  3. each of the four kernels against its plain PyTorch version at the
     main path's scale (12,582,912 rows = bucket_size(1e7)): the
     segmented scans over every flag case REPEATS times (seg_scan_multi
     at every lane set it is timed at and every one the main path
     launches, 1 to 4 lanes of 32-bit and of 64-bit words),
     fused_running_stats over its cases REPEATS times (NaNs, a late lone
     NaN, tile edges, misaligned views), then timings
     (CUDA events, median of 10, the device's time and the time with the
     host's gaps) at the main path's shapes beside their bytes, their
     bound at the H100's 3.35 TB/s and the share of it reached:
     seg_cumsum_i64 (and an unsegmented torch.cumsum of the same column,
     not the same function), seg_scan_multi at q7's, q8's, 3 x 32-bit,
     max_stddevs' 2 x float64 and 3 x 64-bit lanes,
     onehot_segment_sums at q1's and q9's (and the one index_add_ that
     computes the same sums, which the port never calls),
     fused_running_stats;
  4. through connect(device="cuda").execute, each query checked against a
     numpy oracle with its kernel launches counted from zero, and the
     single-pass scans' calls tallied by instantiation (printed with
     their ptxas report):
     - the h2o group-by queries q1 q2 q3 q4 q5 q6 q7 q8 q9 q10 on
       G1_1e7_1e1_0_0 (1e7 rows, K=10, no NAs, seed 42), and a
       computed-key query (the multikey tier);
     - avgs(5, price) and MAX(stddevs(3, price)) under ASSUMING ASC time
       on a trades table of 1e7 rows and 100 symbols (seed 7);
     - q1 q2 q3 q4 q5 q7 q9 q10 on G1_1e7_1e1_5_0 (datagen.h2o_g1 with
       nas=5: 5% of the rows of v1..v3 NULL, every row of 5% of id3's and
       id6's distinct values NULL), the oracle skipping NULL arguments and
       putting the NULL keys in one group, last;
     then best_profit over a 1e7-row price column (the entry point of
     fused_running_stats, which no query calls), checked against numpy;
  5. each query launched its path's kernel: onehot_segment_sums (the
     dense tier), seg_cumsum_i64 (packed and multikey sums, integer
     running sums), seg_scan_multi (min/max, q8's positions, the float64
     running sums), and best_profit fused_running_stats.
The line before the last is the kernel report as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA card is available or the package is missing.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from aquery2_tpu_torch import connect
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.storage.table import Table
from aquery2_tpu_torch.utils.datagen import h2o_g1, trades

ROWS = 10_000_000
CAP = 12_582_912                 # config.bucket_size(1e7)
K_GROUPS = 10
SEED = 42
QUERIES = {                      # bench.QUERIES, all but the joins
    "q1": "SELECT id1, sum(v1) AS v1 FROM source GROUP BY id1",
    "q2": "SELECT id1, id2, sum(v1) AS v1 FROM source GROUP BY id1, id2",
    "q3": "SELECT id3, sum(v1) AS v1, avg(v3) AS v3 FROM source GROUP BY id3",
    "q4": ("SELECT id4, avg(v1) AS v1, avg(v2) AS v2, avg(v3) AS v3 "
           "FROM source GROUP BY id4"),
    "q5": ("SELECT id6, sum(v1) AS v1, sum(v2) AS v2, sum(v3) AS v3 "
           "FROM source GROUP BY id6"),
    "q6": ("SELECT id4, id5, median(v3) AS median_v3, stddev(v3) AS sd "
           "FROM source GROUP BY id4, id5"),
    "q7": ("SELECT id3, max(v1) - min(v2) AS range_v1_v2 FROM source "
           "GROUP BY id3"),
    "q8": ("SELECT id6, subvec(v3, 0, 2) AS largest2_v3 FROM source "
           "ASSUMING DESC v3 GROUP BY id6"),
    "q9": ("SELECT id2, id4, pow(corr(v1, v2), 2) AS r2 FROM source "
           "GROUP BY id2, id4"),
    "q10": ("SELECT id1, id2, id3, id4, id5, id6, sum(v3) AS v3, "
            "count(*) AS cnt FROM source GROUP BY id1, id2, id3, id4, id5, id6"),
    "multikey": ("SELECT id1 * 100 + id4 AS k, sum(v1) AS s, max(v3) AS mx "
                 "FROM source GROUP BY id1 * 100 + id4"),
}
TRADES = {
    "avgs": ("SELECT stocksymbol, avgs(5, price) AS a FROM trades "
             "ASSUMING ASC time GROUP BY stocksymbol"),
    "max_stddevs": ("SELECT stocksymbol, MAX(stddevs(3, price)) AS m "
                    "FROM trades ASSUMING ASC time GROUP BY stocksymbol"),
}
ONEHOT_SHAPES = ("q1", "q2", "q4", "q9")   # the dense tier's queries
NAS_QUERIES = ("q1", "q2", "q3", "q4", "q5", "q7", "q9", "q10")
KEYS = {"q1": ["id1"], "q2": ["id1", "id2"], "q3": ["id3"], "q4": ["id4"],
        "q5": ["id6"], "q6": ["id4", "id5"], "q7": ["id3"], "q8": ["id6"],
        "q9": ["id2", "id4"],
        "q10": ["id1", "id2", "id3", "id4", "id5", "id6"]}
# the kernels each query must launch
MAIN_KERNEL = {"q1": ["onehot_segment_sums"], "q2": ["onehot_segment_sums"],
               "q4": ["onehot_segment_sums"], "q9": ["onehot_segment_sums"],
               "q3": ["seg_cumsum_i64"], "q5": ["seg_cumsum_i64"],
               "q6": ["seg_cumsum_i64"], "q10": ["seg_cumsum_i64"],
               "q7": ["seg_scan_multi"], "q8": ["seg_scan_multi"],
               "multikey": ["seg_cumsum_i64", "seg_scan_multi"],
               "avgs": ["seg_cumsum_i64", "seg_scan_multi"],
               "max_stddevs": ["seg_scan_multi"]}
FLOAT_RTOL = 1e-9       # float sums/averages vs the float64 numpy oracle
EXACT_SUMS_RTOL = {"r2": 1e-12}   # q9: exact int64 sums, float64 formula
ADD_F32_RTOL = 2e-5     # float32 'add' lanes: |err| ≤ this · running Σ|x|
RUN_SUM_TOL = 1e-5      # float32 running sums: |err| ≤ this · running Σ|x|
ADD_F64_TOL = 1e-12     # float64 'add' lanes: |err| ≤ this · running Σ|x|
# trades: the float64 running sums of integer prices are exact in any
# order (below 2^53), and the rest is the oracle's own sequence of
# correctly rounded operations; 1e-12 leaves room for one more rounding
TRADES_RTOL = 1e-12
REPEATS = 20            # runs of each scan per flag case (phase 3)
SLEEP_CYCLES = 2_000_000    # about 1 ms of the card's clock: longer than
                            # the host takes to enqueue one kernel call
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet


def phase(name: str) -> None:
    torch.cuda.synchronize()
    print(f"# {name}", flush=True)


def cuda_ms(fn, reps: int = 10, host_gaps: bool = False) -> float:
    """Median of ``reps`` CUDA-event timings of one fn() (after one
    warm-up). By default each run is queued behind a torch.cuda._sleep of
    SLEEP_CYCLES, so the device is still busy while the host enqueues it
    and the events time the device alone; with host_gaps=True the device
    also waits for the host's enqueueing (a wrapper's checks, allocations
    and ctypes call), as a bare pair of events around one call does."""
    fn()
    times = []
    for _ in range(reps):
        if not host_gaps:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    both_nan = got.isnan() & want.isnan() if got.is_floating_point() else None
    if got.dtype == torch.int64:
        diff = (got - want).abs()        # exact cases: 0 whatever the size
    else:
        diff = (got.double() - want.double()).abs()
    if both_nan is not None:
        diff = torch.where(both_nan, 0.0, diff)
        if bool((got.isnan() != want.isnan()).any()):
            return float("inf")
    return float(diff.max())


def flag_cases(rng, dev):
    """Flag arrays of the main path's densities plus lone flags: one in
    the middle of a tile with no flag in the 3,000-odd tiles before it
    (the longest look-back), one on the first row of a tile of each
    single-pass tile size, one on the last row."""
    cases = {"none": None}
    for name, p in (("1e-6", 1e-6), ("0.1", 0.1), ("0.999", 0.999)):
        cases[name] = torch.from_numpy(rng.random(CAP) < p).to(dev)
    lib = K.build()
    tile = lib.aq_seg_cumsum_i64_tile_rows()
    lone = torch.zeros(CAP, dtype=torch.bool, device=dev)
    lone[(CAP // tile - 2) * tile + tile // 2 + 3] = True
    cases["lone_mid"] = lone
    first = torch.zeros(CAP, dtype=torch.bool, device=dev)
    for i in range(8):
        t = lib.aq_seg_scan_multi_tile_rows(i % 4 + 1, i // 4)
        first[(CAP // t // 2 + 7 * i) * t] = True
    cases["tile_first_rows"] = first
    last = torch.zeros(CAP, dtype=torch.bool, device=dev)
    last[CAP - 1] = True
    cases["last_row"] = last
    return cases


def bound_ms(nbytes: int) -> float:
    """Least time to move nbytes at the H100's published HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def scan_bytes(f, xs) -> int:
    """A scan's bytes: flags and every lane read once, every lane's
    output written once."""
    return (0 if f is None else f.numel()) + 2 * sum(
        x.numel() * x.element_size() for x in xs)


def time_shape(label: str, kernel, plain, nbytes: int) -> dict:
    """Kernel and plain times (CUDA events, median of 10) beside the bound
    of nbytes."""
    ms, pms = cuda_ms(kernel), cuda_ms(plain)
    host = cuda_ms(kernel, host_gaps=True)
    b = bound_ms(nbytes)
    print(f"# {label}: kernel {ms:.4f} ms ({host:.4f} with the host's "
          f"gaps), plain {pms:.4f} ms (median of 10, {CAP} rows); {nbytes} "
          f"bytes ({nbytes / CAP:g} B/row), bound {b:.4f} ms at 3.35 TB/s, "
          f"{b / ms:.1%} of bound", flush=True)
    return {"shape": label, "ms": ms, "ms_with_host": host, "plain_ms": pms,
            "bytes": nbytes, "bound_ms": b, "share_of_bound": b / ms}


def check_repeated(name, kernel, plain, flags, close) -> float:
    """kernel(f) against plain(f) for every flag case, REPEATS times each
    (the plain version once per case): a missing fence shows as an
    occasional wrong carry. close(got, want, f) says whether one output
    matches. Returns the max |err|."""
    err = 0.0
    for case, f in flags.items():
        want = plain(f)
        for rep in range(REPEATS):
            for lane, (g, w) in enumerate(zip(kernel(f), want)):
                if g.dtype != w.dtype:
                    raise AssertionError(f"{name} lane {lane} dtype {g.dtype}")
                if not close(lane, g, w, f):
                    raise AssertionError(
                        f"{name} lane {lane} differs (flags {case}, run "
                        f"{rep}): max |err| {max_abs_err(g, w)}")
                err = max(err, max_abs_err(g, w))
    return err


def exact(lane, g, w, f) -> bool:
    """Equal, NaN where the plain version has NaN."""
    ok = torch.equal(g.isnan(), w.isnan()) if g.is_floating_point() else True
    return ok and torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))


def check_kernels(dev, data) -> list[dict]:
    rng = np.random.default_rng(SEED)
    flags = flag_cases(rng, dev)

    # int64 values near ±2^62: running sums wrap past ±2^63
    x64 = rng.integers(2**62 - 2**20, 2**62, CAP)
    x64[rng.random(CAP) < 0.3] *= -1
    x64 = torch.from_numpy(x64).to(dev)
    err64 = check_repeated(
        "seg_cumsum_i64", lambda f: (K.seg_cumsum_i64(f, x64),),
        lambda f: (K.seg_cumsum_i64_plain(f, x64),), flags, exact)
    errm, err_w, timed_calls = check_multi(rng, dev, flags, x64)
    print(f"# seg_cumsum_i64 and seg_scan_multi (every lane set above) "
          f"equal to their plain versions over {len(flags)} flag cases, "
          f"{REPEATS} runs each (non-integer float32 adds within "
          f"{ADD_F32_RTOL}, float64 adds within {ADD_F64_TOL} of the "
          f"running sum of |x|)", flush=True)
    torch.cuda.synchronize()

    onehot_err, onehot_timed = check_onehot(rng, dev, data)
    run_err, run_timed = check_running(rng, dev)

    # the main path's shapes, at the q3/q7-like density of 0.1
    f = flags["0.1"]
    sum_row = time_shape(
        "seg_cumsum_i64, 1 x int64, density 0.1",
        lambda: K.seg_cumsum_i64(f, x64),
        lambda: K.seg_cumsum_i64_plain(f, x64), scan_bytes(f, (x64,)))
    sum_row["cumsum_ms"] = cuda_ms(lambda: torch.cumsum(x64, 0))
    print(f"# torch.cumsum of the same int64 column (unsegmented, not the "
          f"same function: the single-pass rate this card reaches): "
          f"{sum_row['cumsum_ms']:.4f} ms", flush=True)
    multi_shapes = [time_shape(
        f"seg_scan_multi, {label}, density 0.1",
        lambda: K.seg_scan_multi(f, lanes, lops),
        lambda: K.seg_scan_multi_plain(f, lanes, lops), scan_bytes(f, lanes))
        for label, lanes, lops in timed_calls]
    main = next(s for s in multi_shapes if "3 x 32-bit" in s["shape"])
    rows = [
        {"name": "seg_cumsum_i64", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/seg_cumsum_i64.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:277",
         "max_abs_err": err64, "ms": sum_row["ms"],
         "ms_with_host": sum_row["ms_with_host"],
         "plain_ms": sum_row["plain_ms"], "bound_ms": sum_row["bound_ms"],
         "bound_by": "bytes", "share_of_bound": sum_row["share_of_bound"],
         "library_ms": None, "cumsum_ms": sum_row["cumsum_ms"]},
        {"name": "seg_scan_multi", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/seg_scan_multi.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:339",
         "max_abs_err": errm, "max_abs_err_64bit": err_w,
         "ms": main["ms"], "ms_with_host": main["ms_with_host"],
         "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": "bytes",
         "share_of_bound": main["share_of_bound"], "library_ms": None,
         "shapes": multi_shapes},
        {"name": "onehot_segment_sums", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/onehot_segment_sums.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:438",
         "max_abs_err": onehot_err, "bound_by": "bytes", **onehot_timed},
        {"name": "fused_running_stats", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/fused_running_stats.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:73",
         "max_abs_err": run_err, "bound_by": "bytes",
         "library_ms": None, **run_timed},
    ]
    return rows


def check_multi(rng, dev, flags, x64):
    """seg_scan_multi against its plain version over the flag cases,
    REPEATS times each, for every lane set it is timed at and every one
    the main path launches (each (word width, lane count) is its own tile
    geometry): integer lanes (int64 values near ±2^62, so sums wrap),
    min/max with NaNs and integer-valued float adds exactly; a normal
    float32 add within ADD_F32_RTOL and a normal float64 add within
    ADD_F64_TOL of the running Σ|x| (another order of rounding, and
    another from run to run). Returns the max |err| of the 32-bit and of
    the 64-bit calls, and the (label, lanes, ops) of the timed shapes."""
    def col(a):
        return torch.from_numpy(a).to(dev)
    xi = col(rng.integers(-2**31, 2**31 - 1, CAP).astype(np.int32))
    xf = col(rng.normal(size=CAP).astype(np.float32))
    xfn = xf.clone()
    xfn[col(rng.random(CAP) < 1e-4)] = float("nan")
    xa = col(rng.integers(0, 2, CAP).astype(np.float32))  # exact below 2^24
    v1 = col(rng.integers(1, 6, CAP).astype(np.int32))
    v2 = col(rng.integers(1, 16, CAP).astype(np.int32))
    ones = torch.ones(CAP, dtype=torch.int32, device=dev)
    xd = col(rng.normal(size=CAP) * 1e3)
    xdn = xd.clone()
    xdn[col(rng.random(CAP) < 1e-4)] = float("nan")
    xint = col(rng.integers(-2**20, 2**20, CAP).astype(np.float64))
    loose = {id(xf): ADD_F32_RTOL, id(xd): ADD_F64_TOL}
    # (label, lanes, ops, timed); the main path's: q7's min(v2), max(v1);
    # q8's (and avgs') in-group positions; the multikey query's float32
    # max; max_stddevs' float64 sums of x and x² and its float64 max
    calls = [
        ("q7: int32 min + int32 max", (v2, v1), ("min", "max"), True),
        ("q8: 1 x int32 add (positions)", (ones,), ("add",), True),
        ("1 x float32 max (multikey)", (xfn,), ("max",), False),
        ("1 x float32 add", (xf,), ("add",), False),
        ("3 x 32-bit (int32 max, float32 min, float32 add)",
         (xi, xfn, xa), ("max", "min", "add"), True),
        ("4 x 32-bit", (xi, xfn, xfn, xi), ("add", "min", "max", "min"),
         False),
        ("max_stddevs: 2 x float64 add", (xd, xint), ("add", "add"), True),
        ("max_stddevs: 1 x float64 max", (xdn,), ("max",), False),
        ("3 x 64-bit (int64 max, float64 min, float64 add)",
         (x64, xdn, xd), ("max", "min", "add"), True),
        ("4 x 64-bit int64", (x64, x64, x64, xint),
         ("add", "min", "max", "add"), False),
        ("4 x 64-bit float64", (xdn, x64, xd, xdn),
         ("min", "max", "add", "max"), False),
    ]
    scales = {}

    def close(xs, ops):
        def ok(lane, g, w, f):
            tol = loose.get(id(xs[lane]))
            if tol is None or ops[lane] != "add":
                return exact(lane, g, w, f)
            key = (id(xs[lane]), id(f))
            if key not in scales:
                scales[key] = K.seg_scan_multi_plain(
                    f, (xs[lane].abs().double(),), ("add",))[0]
            diff = (g.double() - w.double()).abs()
            return bool((diff <= tol * scales[key]).all())
        return ok

    err = {4: 0.0, 8: 0.0}
    for label, xs, ops, _ in calls:
        err[xs[0].element_size()] = max(err[xs[0].element_size()],
                                        check_repeated(
            f"seg_scan_multi, {label}",
            lambda f: K.seg_scan_multi(f, xs, ops),
            lambda f: K.seg_scan_multi_plain(f, xs, ops), flags,
            close(xs, ops)))
    scales.clear()
    return err[4], err[8], [c[:3] for c in calls if c[3]]


def capture_onehot(dev, data) -> dict:
    """The (code, lanes, dp) of the first onehot_segment_sums call of each
    dense query (q1 q2 q4 q9) on G1_1e7_1e1_0_0: the main path's inputs,
    its lanes as fused_groupby._build_lanes builds them."""
    db = connect(device=dev)
    load(db, "source", data, dev)
    real, calls, query = K.onehot_segment_sums, {}, [None]

    def spy(code, lanes, dp):
        calls.setdefault(query[0], (code, tuple(lanes), dp))
        return real(code, lanes, dp)
    K.onehot_segment_sums = spy
    try:
        for q in ONEHOT_SHAPES:
            query[0] = q
            db.execute(QUERIES[q])
    finally:
        K.onehot_segment_sums = real
    torch.cuda.synchronize()
    return calls


def route_line(dp, lanes, n) -> str:
    r = K.onehot_route(dp, tuple(x.dtype for x in lanes), n)
    return (f"{'private' if r['private'] else 'shared'} route, "
            f"{r['copies']} copies, {r['threads']} threads x {r['blocks']} "
            f"blocks ({r['blocks_per_sm']} an SM), {r['tile_rows']}-row "
            f"tiles, {r['smem']} B shared memory a block")


def private_limit(dtypes) -> int:
    """The largest dp whose lanes of these dtypes take the private route."""
    dp = 1
    while K.onehot_route(dp + 1, dtypes, CAP)["private"]:
        dp += 1
    return dp


def check_onehot(rng, dev, data):
    """onehot_segment_sums equal to its plain version (torch.equal) over
    dp 2, 11, 101, 513 with 6 mixed lanes; every row in one slot on each
    route; q4's 8-lane mix of the NA variant (4 bool, 2 int32, 2 int64);
    dp x k at the private route's limit and one past it; codes and lanes
    that are views at odd offsets; and 1, 15, 17, a tile - 1, a tile, a
    tile + 1 and five tiles + 123 rows on each route, aligned and not.
    Then timed at the inputs the main path gives it at q1 q2 q4 q9, each
    beside its route and the one index_add_ that computes the same sums."""
    def col(a):
        return torch.from_numpy(a).to(dev)
    x64 = rng.integers(2**62 - 2**20, 2**62, CAP + 3)
    x64[rng.random(CAP + 3) < 0.3] *= -1             # sums wrap past ±2^63
    x64 = col(x64)
    x32 = col(rng.integers(-2**31, 2**31 - 1, CAP + 3).astype(np.int32))
    b50 = col(rng.random(CAP + 3) < 0.5)
    lanes = (x64[:CAP], x32[:CAP], b50[:CAP],
             col(rng.integers(-5, 6, CAP)),
             col(rng.integers(0, 15, CAP).astype(np.int32)),
             col(rng.random(CAP) < 0.999))
    # q4 with NAs: counts, then (:cnt, :sum) for v1 and v2, (:cnt, #A, #B)
    # for v3
    na8 = (b50[:CAP], lanes[5], x32[:CAP], b50[1:CAP + 1], lanes[4],
           lanes[5], x64[:CAP], lanes[3])
    q4 = (b50[:CAP], x32[:CAP], lanes[4], x64[:CAP], lanes[3])
    codes = {dp: col(rng.integers(0, dp, CAP + 1).astype(np.int32))
             for dp in (2, 11, 101, 513)}
    cases = [(f"dp {dp}, 6 lanes", codes[dp][:CAP], lanes, dp)
             for dp in codes]
    cases += [
        ("every row in slot 7, dp 513", torch.full(
            (CAP,), 7, dtype=torch.int32, device=dev), lanes, 513),
        ("every row in slot 3, dp 11", torch.full(
            (CAP,), 3, dtype=torch.int32, device=dev), q4, 11),
        ("q4's 8-lane NA mix, dp 11", codes[11][:CAP], na8, 11),
        ("q4's 8-lane NA mix, dp 101 (copies shared by warps)",
         codes[101][:CAP], na8, 101)]
    lim = private_limit(tuple(x.dtype for x in q4))
    for dp in (lim, lim + 1):
        c = col(rng.integers(0, dp, CAP).astype(np.int32))
        cases.append((f"q4's lanes at dp {dp} ({'at' if dp == lim else 'one past'}"
                      f" the private route's limit)", c, q4, dp))
    n = CAP - 3
    odd = (x64[3:n + 3], x32[1:n + 1], b50[3:n + 3], x64[1:n + 1],
           b50[1:n + 1])
    for dp in (11, 101):
        cases.append((f"views at offsets 1 and 3, dp {dp}",
                      codes[dp][1:n + 1], odd, dp))
    for dp in (11, 101):
        tile = K.onehot_route(dp, tuple(x.dtype for x in q4), CAP)["tile_rows"]
        for n in (1, 15, 17, tile - 1, tile, tile + 1, 5 * tile + 123):
            for off in (0, 3):
                cases.append((f"{n} rows at offset {off}, dp {dp}",
                              codes[dp][off:off + n],
                              tuple(x[off:off + n] for x in q4), dp))
    err = 0.0
    for label, code, ls, dp in cases:
        got = K.onehot_segment_sums(code, ls, dp)
        want = K.onehot_segment_sums_plain(code, ls, dp)
        err = max(err, max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"onehot_segment_sums differs ({label}): "
                                 f"max |err| {max_abs_err(got, want)}")
    print(f"# onehot_segment_sums equal to its plain version in {len(cases)} "
          f"cases; q4's lanes take the private route up to dp {lim} "
          f"({lim * len(q4)} entries): dp {lim} {route_line(lim, q4, CAP)}; "
          f"dp {lim + 1} {route_line(lim + 1, q4, CAP)}; the 8-lane NA mix "
          f"at dp 101: {route_line(101, na8, CAP)}", flush=True)

    timed = {}
    for q, (code, ls, dp) in capture_onehot(dev, data).items():
        got = K.onehot_segment_sums(code, ls, dp)
        if not torch.equal(got, K.onehot_segment_sums_plain(code, ls, dp)):
            raise AssertionError(f"onehot_segment_sums differs at {q}")
        # the library call for the same function, prepared outside the
        # timing: one index_add_ of an [n, k] int64 source (the port never
        # calls it)
        code64 = code.to(torch.int64)
        src = torch.stack([x.to(torch.int64) for x in ls], 1)

        def library():
            return torch.zeros(dp, len(ls), dtype=torch.int64,
                               device=dev).index_add_(0, code64, src)
        if not torch.equal(library(), got):
            raise AssertionError(f"index_add_ differs at {q}")
        nbytes = (code.numel() * code.element_size()
                  + sum(x.numel() * x.element_size() for x in ls)
                  + got.numel() * got.element_size())
        kinds = ", ".join(str(x.dtype).removeprefix("torch.") for x in ls)
        print(f"# onehot_segment_sums at {q}: {code.numel()} rows, dp {dp}, "
              f"lanes ({kinds}): {route_line(dp, ls, code.numel())}",
              flush=True)
        timed[q] = time_shape(
            f"onehot_segment_sums at {q}'s inputs (dp {dp}, {len(ls)} "
            f"lanes)", lambda: K.onehot_segment_sums(code, ls, dp),
            lambda: K.onehot_segment_sums_plain(code, ls, dp), nbytes)
        timed[q]["library_ms"] = cuda_ms(library)
        timed[q]["route"] = K.onehot_route(dp, tuple(x.dtype for x in ls),
                                           code.numel())
        print(f"# index_add_ of the [n, {len(ls)}] int64 source at {q}: "
              f"{timed[q]['library_ms']:.4f} ms", flush=True)
    if sorted(timed) != sorted(ONEHOT_SHAPES):
        raise AssertionError(f"dense queries called onehot_segment_sums: "
                             f"{sorted(timed)}")
    row = {k: timed["q9"][k] for k in ("ms", "ms_with_host", "plain_ms",
                                       "bound_ms", "share_of_bound",
                                       "library_ms")}
    row["shapes"] = list(timed.values())
    return err, row


def sass_atomics() -> dict[str, collections.Counter]:
    """The atomic instructions of each onehot_segment_sums instantiation in
    the built library's SASS (cuobjdump -sass): whether its shared 64-bit
    add is one ATOMS.ADD.64 or a compare-and-swap loop. Empty when the
    toolkit has no cuobjdump."""
    tool = Path(K._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(K.library_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    per, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = K._kernel_name(m[1]) if "onehot" in m[1] else None
            if name:
                per[name] = collections.Counter()
        elif name:
            m = re.search(r"\b(?:ATOMS|ATOMG|ATOM|RED)\.[\w.]+", line)
            if m:
                per[name][m[0]] += 1
    return per


def check_running(rng, dev):
    """fused_running_stats against its plain version, each case REPEATS
    times in a row (the first call's scratch newly allocated after
    torch.cuda.empty_cache(), the rest the allocator's reused blocks; a
    missing fence shows as an occasional wrong carry): {0, 1} values (float32 sums exact below
    2^24), normal values, normal values with NaNs, a lone NaN in the
    middle of a late tile after thousands of NaN-free tiles, 1, tile - 1,
    tile, tile + 1 and 3 tiles + 5 rows, and the misaligned views x[1:]
    and x[3:]. Min and max equal the plain version's (NaN where it has
    NaN), sums NaN where it has NaN and elsewhere within RUN_SUM_TOL of
    the running sum of |x| of a float64 cumsum. Then best_profit equal to
    the plain computation, and the timing at 12,582,912 rows."""
    def col(a):
        return torch.from_numpy(a).to(dev)
    tile = K.build().aq_fused_running_stats_tile_rows()
    xn = col(rng.normal(size=CAP + 3).astype(np.float32))
    xnan = xn.clone()
    xnan[col(rng.random(CAP + 3) < 1e-6)] = float("nan")
    lone = xn.clone()
    lone[(CAP // tile - 2) * tile + tile // 2 + 3] = float("nan")
    cases = {"{0, 1}": col(rng.integers(0, 2, CAP).astype(np.float32)),
             "normal": xn[:CAP], "NaN 1e-6": xnan[:CAP],
             "lone NaN in a late tile": lone[:CAP],
             "x[1:]": xnan[1:CAP + 1], "x[3:]": xnan[3:CAP + 3]}
    for n in (1, tile - 1, tile, tile + 1, 3 * tile + 5):
        cases[f"{n} rows"] = xnan[:n]
    err = 0.0
    for case, x in cases.items():
        want = K.fused_running_stats_plain(x)
        exact_sum = torch.cumsum(torch.nan_to_num(x).double(), 0)
        scale = torch.cumsum(torch.nan_to_num(x).double().abs(), 0)
        torch.cuda.empty_cache()
        for rep in range(REPEATS):
            got = K.fused_running_stats(x)
            for lane, (g, w) in enumerate(zip(got, want)):
                ok = torch.equal(g.isnan(), w.isnan())
                if lane:
                    ok = ok and exact(lane, g, w, None)
                else:
                    num = ~g.isnan()
                    ok = ok and bool(((g.double() - exact_sum).abs()[num]
                                      <= RUN_SUM_TOL * scale[num]).all())
                    err = max(err, max_abs_err(g, w))
                if not ok:
                    raise AssertionError(
                        f"fused_running_stats lane {lane} differs ({case}, "
                        f"run {rep}): max |err| {max_abs_err(g, w)}")
    x01 = cases["{0, 1}"]
    if not all(torch.equal(g, w) for g, w in zip(
            K.fused_running_stats(x01), K.fused_running_stats_plain(x01))):
        raise AssertionError("fused_running_stats sums of {0, 1} not exact")
    xn = cases["normal"]
    idx = torch.arange(CAP, device=dev)
    for n in (ROWS, CAP):
        bp = K.best_profit(xn, n)
        plain = torch.where(idx < n, xn - torch.cummin(xn, 0).values,
                            float("-inf")).max()
        if not torch.equal(bp, plain):
            raise AssertionError(f"best_profit {bp} vs plain {plain}")
    print(f"# fused_running_stats ({tile}-row tiles) equal to its plain "
          f"version in {len(cases)} cases, {REPEATS} runs each: min, max "
          f"and the {{0, 1}} sums exactly, the other sums within "
          f"{RUN_SUM_TOL} of the running sum of |x| (max |err| vs plain "
          f"{err}); best_profit equal", flush=True)
    timed = time_shape("fused_running_stats",
                       lambda: K.fused_running_stats(xn),
                       lambda: K.fused_running_stats_plain(xn),
                       4 * xn.numel() * xn.element_size())
    timed.pop("shape")
    timed.pop("bytes")
    return err, timed


def _groups(keycols: dict[str, np.ndarray]):
    """Key-ascending groups of the rows: (sorted unique key columns,
    inverse, row order grouped, group starts in that order, counts)."""
    code = np.zeros(ROWS, np.int64)
    radix = {}
    for k, v in keycols.items():
        lo = int(v.min())
        radix[k] = (lo, int(v.max()) - lo + 1)
        code = code * radix[k][1] + (v - lo)
    ucode, inv = np.unique(code, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    starts = np.r_[0, np.flatnonzero(np.diff(inv[order])) + 1]
    keys = {}
    for k in reversed(list(keycols)):
        lo, r = radix[k]
        keys[k] = ucode % r + lo
        ucode = ucode // r
    return {k: keys[k] for k in keycols}, inv, order, starts, np.bincount(inv)


def oracle(data: dict[str, np.ndarray], q: str):
    """(answer, per-group row counts, {key: NULL mask}): the query computed
    on the host with numpy, key-ascending. On masked columns (the NA
    variant) a NULL key codes as (max + 1), so the NULLs make one group,
    last, and aggregates skip NULL arguments."""
    def col(nm):
        c = data[nm]
        return np.ma.getdata(c), ~np.ma.getmaskarray(c)

    keycols = {}
    if q == "multikey":
        keycols["k"] = col("id1")[0].astype(np.int64) * 100 + col("id4")[0]
    for k in KEYS.get(q, []):
        v, ok = col(k)
        v = v.astype(np.int64)
        keycols[k] = np.where(ok, v, v[ok].max() + 1)
    keys, inv, order, starts, cnt = _groups(keycols)
    out, nulls = {}, {}
    for k, kv in keys.items():
        if k == "k":                             # the computed key
            out[k] = kv.astype(np.int32)
            continue
        v, ok = col(k)
        nulls[k] = kv == int(v[ok].max()) + 1    # the sentinel group
        out[k] = np.where(nulls[k], 0, kv).astype(np.int32)

    def isum(nm):
        v, ok = col(nm)
        return np.bincount(inv, weights=np.where(ok, v, 0).astype(np.float64)
                           ).astype(np.int64)

    def fsum(nm):
        v, ok = col(nm)
        return np.bincount(inv, weights=np.where(ok, v, 0).astype(np.float64))

    def nn(nm):
        return np.maximum(np.bincount(inv, weights=col(nm)[1]), 1)

    def extreme(nm, fn, ident):
        v, ok = col(nm)
        return fn.reduceat(np.where(ok, v, ident)[order], starts)

    if q in ("q1", "q2"):
        out["v1"] = isum("v1")
    elif q == "q3":
        out["v1"], out["v3"] = isum("v1"), fsum("v3") / nn("v3")
    elif q == "q4":
        for nm in ("v1", "v2", "v3"):
            out[nm] = fsum(nm) / nn(nm)
    elif q == "q5":
        out["v1"], out["v2"], out["v3"] = isum("v1"), isum("v2"), fsum("v3")
    elif q == "q6":
        v = col("v3")[0]
        byval = np.lexsort((v, inv))             # group, then value
        sv = v[byval].astype(np.float64)
        out["median_v3"] = (sv[starts + (cnt - 1) // 2]
                            + sv[starts + cnt // 2]) * 0.5
        s1 = fsum("v3")
        s2 = np.bincount(inv, weights=(v * v).astype(np.float64))  # f32 sq
        den = cnt + 1.0                          # var divides by n + 1
        out["sd"] = np.sqrt(np.maximum((s2 - s1 * s1 / den) / den, 0.0))
    elif q == "q7":
        mx = extreme("v1", np.maximum, np.iinfo(np.int32).min)
        mn = extreme("v2", np.minimum, np.iinfo(np.int32).max)
        out["range_v1_v2"] = (mx.astype(np.int64) - mn).astype(np.int32)
    elif q == "q9":
        (x, okx), (y, oky) = col("v1"), col("v2")
        ok = okx & oky
        x, y = np.where(ok, x, 0).astype(np.int64), np.where(ok, y, 0)
        sx, sy, sxy, sx2, sy2 = (
            np.bincount(inv, weights=a.astype(np.float64))
            for a in (x, y, x * y, x * x, y * y))
        n2 = np.bincount(inv, weights=ok)
        r = (n2 * sxy - sx * sy) / np.sqrt((n2 * sx2 - sx * sx)
                                           * (n2 * sy2 - sy * sy))
        out["r2"] = r ** 2
    elif q == "multikey":
        out["s"] = isum("v1")
        out["mx"] = extreme("v3", np.maximum, -np.inf).astype(np.float32)
    else:
        out["v3"], out["cnt"] = fsum("v3"), cnt.astype(np.int64)
    return out, cnt, nulls


def check_result(q: str, res, want: dict[str, np.ndarray],
                 cnt: np.ndarray, nulls: dict[str, np.ndarray]) -> None:
    """Keys, their NULLs, counts, integer sums, min/max and medians
    exactly; float sums, averages and stddev to FLOAT_RTOL plus the limb
    split's rounding of each row (at most 2^-39 per row, so cnt · 2^-39
    per group); q9's r2, from exact integer sums, to EXACT_SUMS_RTOL."""
    names = res.column_names()
    if names != list(want):
        raise AssertionError(f"{q}: columns {names}, want {list(want)}")
    for nm, null in nulls.items():
        v = res.table.columns[nm].valid
        got_null = (np.zeros(res.nrows, bool) if v is None
                    else ~v[:res.nrows].cpu().numpy())
        np.testing.assert_array_equal(got_null, null, err_msg=f"{q}.{nm} NULL")
    for nm in names:
        got = res.table.columns[nm].to_numpy()
        w = want[nm]
        if got.shape != w.shape:
            raise AssertionError(f"{q}.{nm}: shape {got.shape} vs {w.shape}")
        if nm == "median_v3":
            np.testing.assert_array_equal(got, w, err_msg=f"{q}.{nm}")
        elif got.dtype.kind == "f" and nm != "mx":
            if not np.isfinite(got).all():
                raise AssertionError(f"{q}.{nm}: non-finite values")
            tol = (EXACT_SUMS_RTOL[nm] * np.abs(w) if nm in EXACT_SUMS_RTOL
                   else FLOAT_RTOL * np.abs(w) + cnt * 2.0**-39)
            bad = np.abs(got - w) > tol
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                raise AssertionError(f"{q}.{nm}: {int(bad.sum())} groups "
                                     f"differ, first {i}: {got[i]!r} vs "
                                     f"{w[i]!r}")
        else:
            if got.dtype != w.dtype:
                raise AssertionError(f"{q}.{nm}: dtype {got.dtype} vs {w.dtype}")
            np.testing.assert_array_equal(got, w, err_msg=f"{q}.{nm}")


def check_q8(res, data) -> None:
    """q8: per id6, its two largest v3 in descending order, and the
    VectorColumn's offsets (cumulative min(count, 2))."""
    id6, v3 = data["id6"], data["v3"]
    ids, cnt = np.unique(id6, return_counts=True)
    order = np.lexsort((-v3, id6))
    first = np.r_[0, np.cumsum(cnt)[:-1]]
    pos = np.arange(ROWS) - np.repeat(first, cnt)
    cols = res.table.columns
    if res.column_names() != ["id6", "largest2_v3"]:
        raise AssertionError(f"q8: columns {res.column_names()}")
    np.testing.assert_array_equal(cols["id6"].to_numpy(), ids, err_msg="q8 id6")
    v = cols["largest2_v3"]
    np.testing.assert_array_equal(v.offsets_numpy(),
                                  np.r_[0, np.cumsum(np.minimum(cnt, 2))],
                                  err_msg="q8 offsets")
    np.testing.assert_array_equal(v.to_numpy(), v3[order][pos < 2],
                                  err_msg="q8 values")


def timed_runs(db, sql: str, reps: int):
    """(result of a first run, median ms of ``reps`` warm runs), host
    clock around execute plus a synchronize."""
    res = db.execute(sql)              # first run: caches, allocator
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t1 = time.perf_counter()
        db.execute(sql)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t1)
    return res, float(np.median(runs)) * 1e3


def run_queries(db, queries: dict[str, str], check, reps: int = 3,
                tag: str = "") -> dict[str, dict[str, int]]:
    """Each query: its launches counted from zero over its runs, the
    result checked by check(q, res), the median warm time printed."""
    launches = {}
    for q, sql in queries.items():
        reset_launches()
        res, ms = timed_runs(db, sql, reps)
        launches[q + tag] = {k: v for k, v in K.LAUNCHES.items() if v}
        check(q, res)
        print(f"# {q}{tag}: {res.nrows} groups, {ms:.3f} ms (median of "
              f"{reps} warm runs), matches the numpy oracle, launches "
              f"{launches[q + tag]}", flush=True)
    return launches


def load(db, name, arrays, dev, **kw) -> None:
    t0 = time.perf_counter()
    db.catalog.create(Table.from_numpy(name, arrays, device=dev, **kw))
    torch.cuda.synchronize()
    print(f"# loaded {name}: {ROWS} rows x {len(arrays)} columns, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def run_slice(dev, data) -> dict[str, dict[str, int]]:
    """The h2o queries and the computed-key query on G1_1e7_1e1_0_0."""
    db = connect(device=dev)
    load(db, "source", data, dev)

    def check(q, res):
        if q == "q8":
            check_q8(res, data)
        else:
            check_result(q, res, *oracle(data, q))
    return run_queries(db, QUERIES, check)


def trades_oracle(arrays, q: str):
    """Per symbol (code order): avgs(5, price) as flat values with
    offsets, or MAX(stddevs(3, price)); rows ordered by time within each
    symbol, ties in insertion order."""
    sym, t, price = arrays["stocksymbol"], arrays["time"], arrays["price"]
    order = np.lexsort((t, sym))
    syms, cnt = np.unique(sym, return_counts=True)
    first = np.repeat(np.r_[0, np.cumsum(cnt)[:-1]], cnt)
    pos = np.arange(ROWS) - first
    p = price[order].astype(np.int64)
    c = np.cumsum(p)
    c = c - np.r_[0, c][first]                   # running sum in the group

    def window(run, w):
        behind = np.where(pos >= w, np.arange(ROWS) - w, 0)
        return np.where(pos >= w, run - run[behind], run)

    if q == "avgs":
        a = window(c, 5) / np.minimum(pos + 1, 5).astype(np.float64)
        return syms, cnt, a
    pf = p.astype(np.float64)
    sq = np.cumsum(pf * pf)
    sq = sq - np.r_[0.0, sq][first]
    cnt3 = np.minimum(pos + 1, 3).astype(np.float64)
    mean = window(c.astype(np.float64), 3) / cnt3
    var = np.maximum(window(sq, 3) / cnt3 - mean * mean, 0.0)
    sd = np.sqrt(var)
    return syms, cnt, np.maximum.reduceat(sd, np.r_[0, np.cumsum(cnt)[:-1]])


def run_trades(dev) -> dict[str, dict[str, int]]:
    """The trades queries on 1e7 rows and 100 symbols (seed 7)."""
    arrays, d = trades(ROWS, 100, 7)
    db = connect(device=dev)
    load(db, "trades", arrays, dev, types={"stocksymbol": T.StrT},
         dictionaries={"stocksymbol": d})

    def check(q, res):
        syms, cnt, want = trades_oracle(arrays, q)
        cols = res.table.columns
        np.testing.assert_array_equal(cols["stocksymbol"].to_numpy(), syms,
                                      err_msg=f"{q} symbols")
        if q == "avgs":
            np.testing.assert_array_equal(cols["a"].offsets_numpy(),
                                          np.r_[0, np.cumsum(cnt)])
            got = cols["a"].to_numpy()
        else:
            got = cols["m"].to_numpy()
        if got.dtype != np.float64 or got.shape != want.shape:
            raise AssertionError(f"{q}: {got.dtype} {got.shape}")
        err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                           1e-300)))
        if not err <= TRADES_RTOL:
            raise AssertionError(f"{q}: max relative error {err}")
    return run_queries(db, TRADES, check)


def run_nas(dev) -> dict[str, dict[str, int]]:
    """q1 q2 q3 q4 q5 q7 q9 q10 on G1_1e7_1e1_5_0."""
    data = h2o_g1(ROWS, K_GROUPS, SEED, nas=5)
    db = connect(device=dev)
    load(db, "source", data, dev)
    return run_queries(db, {q: QUERIES[q] for q in NAS_QUERIES},
                       lambda q, res: check_result(q, res, *oracle(data, q)),
                       tag="@5pct_NA")


def run_best_profit(dev) -> dict[str, int]:
    """best_profit over a 1e7-row price column (a random walk, padded to
    the capacity), against numpy; returns the launches of that call."""
    rng = np.random.default_rng(SEED)
    walk = 1000.0 + np.cumsum(rng.normal(size=ROWS))
    prices = np.zeros(CAP, np.float32)
    prices[:ROWS] = np.round(walk, 2).astype(np.float32)
    x = torch.from_numpy(prices).to(dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = float(K.best_profit(x, ROWS))
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    p = prices[:ROWS]
    want = float((p - np.minimum.accumulate(p)).max())
    if got != want:
        raise AssertionError(f"best_profit {got} vs numpy {want}")
    print(f"# best_profit over {ROWS} prices: {got} in {ms:.3f} ms (one "
          f"call), matches numpy, launches {launches}", flush=True)
    return launches


def ptxas_line(r: dict) -> str:
    return (f"{r['registers']} registers, {r['spill_stores']} B spill "
            f"stores, {r['spill_loads']} B spill loads, {r['stack']} B "
            f"stack, {r['smem']} B static shared memory")


def tally_scans(calls: collections.Counter):
    """Wrap K.seg_cumsum_i64 and K.seg_scan_multi, which the engine calls
    through the module, so that calls tallies each call by the name of
    the instantiation it runs, as ptxas_report names it (the wrappers
    still count their launches). Returns the function that unwraps
    them."""
    cumsum, multi = K.seg_cumsum_i64, K.seg_scan_multi

    def seg_cumsum_i64(flags, x):
        calls[f"seg_cumsum_i64, flags {int(flags is not None)}"] += 1
        return cumsum(flags, x)

    def seg_scan_multi(flags, xs, ops):
        xs = tuple(xs)
        calls[f"seg_scan_multi {len(xs)} x {8 * xs[0].element_size()}-bit, "
              f"flags {int(flags is not None)}"] += 1
        return multi(flags, xs, ops)

    K.seg_cumsum_i64, K.seg_scan_multi = seg_cumsum_i64, seg_scan_multi

    def untally():
        K.seg_cumsum_i64, K.seg_scan_multi = cumsum, multi
    return untally


def reset_launches() -> None:
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    phase("1. card")
    print(card)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    lib = K.build()
    phase("2. build")
    print(f"# built {K.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = {r["kernel"]: r for r in K.ptxas_report()}
    for r in ptxas.values():
        print(f"# ptxas {r['kernel']}: {ptxas_line(r)}")
    for name, ops in sass_atomics().items():
        print(f"# SASS atomics of {name}: {dict(sorted(ops.items()))}")
    if lib.aq_onehot_max_entries() != K.ONEHOT_MAX_ENTRIES:
        raise AssertionError("ONEHOT_MAX_ENTRIES differs from the kernel's")

    data = h2o_g1(ROWS, K_GROUPS, SEED)
    rows = check_kernels(dev, data)
    phase("3. kernels vs plain: equal")

    scans = collections.Counter()
    untally = tally_scans(scans)
    launches = run_slice(dev, data)
    launches.update(run_trades(dev))
    launches.update(run_nas(dev))
    untally()
    launches["best_profit"] = run_best_profit(dev)
    phase(f"4. slice: {len(launches) - 1} queries and best_profit match the "
          f"oracles")

    for q, per in launches.items():
        for name in MAIN_KERNEL.get(q.split("@")[0], ["fused_running_stats"]):
            if per.get(name, 0) <= 0:
                raise AssertionError(f"{q} did not launch {name}: {per}")
    for r in rows:
        r["launches"] = sum(per.get(r["name"], 0)
                            for per in launches.values())
    for name, calls in sorted(scans.items()):
        print(f"# phase 4 called {name} {calls} times; ptxas: "
              f"{ptxas_line(ptxas[name])}", flush=True)
    phase("5. each query launched its path's kernels, best_profit "
          "fused_running_stats")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
