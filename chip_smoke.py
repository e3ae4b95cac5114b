#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aquery2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any mismatch raises; there is no fallback):
  1. identify the card (nvidia-smi name and power limit, torch, CUDA);
  2. build the CUDA kernels from aquery2_tpu_torch/csrc/;
  3. each of the four kernels against its plain PyTorch version at the
     main path's shape (12,582,912 rows = bucket_size(1e7)), with timings;
     seg_scan_multi with its 32-bit and its 64-bit lanes;
  4. through connect(device="cuda").execute, each query checked against a
     numpy oracle with its kernel launches counted from zero:
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

import json
import subprocess
import sys
import time

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
ADD_F32_RTOL = 2e-5     # float32 'add' lanes: another order of rounding
RUN_SUM_TOL = 1e-5      # float32 running sums: |err| ≤ this · running Σ|x|
ADD_F64_TOL = 1e-12     # float64 'add' lanes: |err| ≤ this · running Σ|x|
# trades: the float64 running sums of integer prices are exact in any
# order (below 2^53), and the rest is the oracle's own sequence of
# correctly rounded operations; 1e-12 leaves room for one more rounding
TRADES_RTOL = 1e-12


def phase(name: str) -> None:
    torch.cuda.synchronize()
    print(f"# {name}", flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of fn() (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
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
    """Flag arrays of the main path's densities plus lone boundaries."""
    cases = {"none": None}
    for name, p in (("1e-6", 1e-6), ("0.1", 0.1), ("0.999", 0.999)):
        cases[name] = torch.from_numpy(rng.random(CAP) < p).to(dev)
    tile = K.build().aq_seg_cumsum_i64_tile_rows()
    lone = torch.zeros(CAP, dtype=torch.bool, device=dev)
    ntiles = CAP // tile
    lone[ntiles // 3 * tile + tile // 2 + 3] = True    # mid-tile
    lone[2 * ntiles // 3 * tile] = True                # first row of a tile
    cases["lone"] = lone
    return cases


def check_kernels(dev) -> list[dict]:
    rng = np.random.default_rng(SEED)
    flags = flag_cases(rng, dev)

    # int64 values near ±2^62: running sums wrap past ±2^63
    x64 = rng.integers(2**62 - 2**20, 2**62, CAP)
    x64[rng.random(CAP) < 0.3] *= -1
    x64 = torch.from_numpy(x64).to(dev)
    err64 = 0.0
    for name, f in flags.items():
        got = K.seg_cumsum_i64(f, x64)
        want = K.seg_cumsum_i64_plain(f, x64)
        if not torch.equal(got, want):
            raise AssertionError(f"seg_cumsum_i64 differs (flags {name}): "
                                 f"max |err| {max_abs_err(got, want)}")
        err64 = max(err64, max_abs_err(got, want))

    # k = 3 lanes: int32 max, float32 min with NaNs, float32 add. The add
    # lane is integer-valued so its sums stay exact below 2^24.
    xi = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, CAP,
                                       dtype=np.int64).astype(np.int32))
    xf = torch.from_numpy(rng.normal(size=CAP).astype(np.float32))
    xf[torch.from_numpy(rng.random(CAP) < 1e-4)] = float("nan")
    xa = torch.from_numpy(rng.integers(0, 2, CAP).astype(np.float32))
    xs = (xi.to(dev), xf.to(dev), xa.to(dev))
    ops = ("max", "min", "add")
    errm = 0.0
    for name, f in flags.items():
        got = K.seg_scan_multi(f, xs, ops)
        want = K.seg_scan_multi_plain(f, xs, ops)
        for lane, (g, w, op) in enumerate(zip(got, want, ops)):
            if g.dtype != w.dtype:
                raise AssertionError(f"lane {lane} dtype {g.dtype}")
            if op == "add" and g.is_floating_point():
                ok = torch.allclose(g, w, rtol=ADD_F32_RTOL, atol=0.0)
            else:
                ok = torch.equal(g.isnan(), w.isnan()) if \
                    g.is_floating_point() else True
                ok = ok and torch.equal(torch.nan_to_num(g),
                                        torch.nan_to_num(w))
            errm = max(errm, max_abs_err(g, w))
            if not ok:
                raise AssertionError(f"seg_scan_multi lane {lane} ({op}) "
                                     f"differs (flags {name}): max |err| "
                                     f"{max_abs_err(g, w)}")
    torch.cuda.synchronize()

    err_w, timed_w = check_scan64(rng, dev, flags)
    onehot_err, onehot_timed = check_onehot(rng, dev)
    run_err, run_timed = check_running(rng, dev)

    f = flags["0.1"]               # the q3/q7-like density
    rows = [
        {"name": "seg_cumsum_i64", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/seg_cumsum_i64.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:277",
         "max_abs_err": err64,
         "ms": cuda_ms(lambda: K.seg_cumsum_i64(f, x64)),
         "plain_ms": cuda_ms(lambda: K.seg_cumsum_i64_plain(f, x64))},
        {"name": "seg_scan_multi", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/seg_scan_multi.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:339",
         "max_abs_err": errm,
         "ms": cuda_ms(lambda: K.seg_scan_multi(f, xs, ops)),
         "plain_ms": cuda_ms(lambda: K.seg_scan_multi_plain(f, xs, ops)),
         "max_abs_err_64bit": err_w, **timed_w},
    ]
    for r in rows:
        print(f"# {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms (median of 10, {CAP} rows, flag "
              f"density 0.1), max |err| {r['max_abs_err']}", flush=True)
    rows.append({"name": "onehot_segment_sums", "route": "cuda",
                 "source": "aquery2_tpu_torch/csrc/onehot_segment_sums.cu",
                 "replaces": "aquery2_tpu/ops/pallas_kernels.py:438",
                 "max_abs_err": onehot_err, **onehot_timed["q9"]})
    rows.append({"name": "fused_running_stats", "route": "cuda",
                 "source": "aquery2_tpu_torch/csrc/fused_running_stats.cu",
                 "replaces": "aquery2_tpu/ops/pallas_kernels.py:73",
                 "max_abs_err": run_err, **run_timed})
    return rows


def check_scan64(rng, dev, flags):
    """seg_scan_multi's 64-bit lanes against its plain version over the
    flag cases: int64 add (values near ±2^62, so sums wrap), min, max;
    float64 min/max with NaNs; an integer-valued float64 add (exact in
    any order); a normal float64 add, within ADD_F64_TOL of the running
    Σ|x| (another order of rounding). Timed with 3 lanes (int64 max,
    float64 min, float64 add), the 32-bit row's shape, at density 0.1."""
    x64 = rng.integers(2**62 - 2**20, 2**62, CAP)
    x64[rng.random(CAP) < 0.3] *= -1
    x64 = torch.from_numpy(x64).to(dev)
    xd = torch.from_numpy(rng.normal(size=CAP) * 1e3).to(dev)
    xnan = xd.clone()
    xnan[torch.from_numpy(rng.random(CAP) < 1e-4).to(dev)] = float("nan")
    xint = torch.from_numpy(rng.integers(-2**20, 2**20, CAP)
                            .astype(np.float64)).to(dev)
    calls = [((x64, x64, x64, xint), ("add", "min", "max", "add")),
             ((xnan, x64, xd, xnan), ("min", "max", "add", "max"))]
    err = 0.0
    for name, f in flags.items():
        for xs, ops in calls:
            got = K.seg_scan_multi(f, xs, ops)
            want = K.seg_scan_multi_plain(f, xs, ops)
            for lane, (g, w, x, op) in enumerate(zip(got, want, xs, ops)):
                if g.dtype != w.dtype:
                    raise AssertionError(f"64-bit lane {lane} dtype {g.dtype}")
                if op == "add" and x is xd:
                    scale = K.seg_scan_multi_plain(f, (x.abs(),), ("add",))[0]
                    ok = bool(((g - w).abs() <= ADD_F64_TOL * scale).all())
                else:
                    ok = torch.equal(g.isnan(), w.isnan()) if \
                        g.is_floating_point() else True
                    ok = ok and torch.equal(torch.nan_to_num(g),
                                            torch.nan_to_num(w))
                err = max(err, max_abs_err(g, w))
                if not ok:
                    raise AssertionError(
                        f"seg_scan_multi 64-bit lane {lane} ({op}, "
                        f"{g.dtype}) differs (flags {name}): max |err| "
                        f"{max_abs_err(g, w)}")
    f = flags["0.1"]
    xs, ops = (x64, xnan, xd), ("max", "min", "add")
    timed = {"ms_64bit": cuda_ms(lambda: K.seg_scan_multi(f, xs, ops)),
             "plain_ms_64bit": cuda_ms(
                 lambda: K.seg_scan_multi_plain(f, xs, ops))}
    print(f"# seg_scan_multi, 64-bit lanes (int64 max, float64 min, float64 "
          f"add): kernel {timed['ms_64bit']:.4f} ms, plain "
          f"{timed['plain_ms_64bit']:.4f} ms (median of 10, {CAP} rows, flag "
          f"density 0.1); equal over the flag cases (float64 adds within "
          f"{ADD_F64_TOL} of the running sum of |x|), max |err| {err}",
          flush=True)
    return err, timed


def check_onehot(rng, dev):
    """onehot_segment_sums equal to its plain version (torch.equal) over
    dp 2, 11, 101, 513 with 6 mixed lanes, and with every row in one slot;
    then timed at the shapes q1 and q9 give it."""
    x64 = rng.integers(2**62 - 2**20, 2**62, CAP)
    x64[rng.random(CAP) < 0.3] *= -1                 # sums wrap past ±2^63
    lanes = (torch.from_numpy(x64).to(dev),
             torch.from_numpy(rng.integers(-2**31, 2**31 - 1, CAP)
                              .astype(np.int32)).to(dev),
             torch.from_numpy(rng.random(CAP) < 0.5).to(dev),
             torch.from_numpy(rng.integers(-5, 6, CAP)).to(dev),
             torch.from_numpy(rng.integers(0, 15, CAP).astype(np.int32)
                              ).to(dev),
             torch.from_numpy(rng.random(CAP) < 0.999).to(dev))
    cases = [(dp, torch.from_numpy(rng.integers(0, dp, CAP).astype(np.int32)
                                   ).to(dev)) for dp in (2, 11, 101, 513)]
    cases.append((513, torch.full((CAP,), 7, dtype=torch.int32, device=dev)))
    err = 0.0
    for dp, code in cases:
        got = K.onehot_segment_sums(code, lanes, dp)
        want = K.onehot_segment_sums_plain(code, lanes, dp)
        err = max(err, max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"onehot_segment_sums differs (dp {dp}): "
                                 f"max |err| {max_abs_err(got, want)}")

    # the main path's shapes: codes of 1e7 valid rows, the rest in the
    # overflow slot; q1 = (counts, sum(v1)); q9 = counts and corr's five
    # sums (int32 sx, sy; int64 sxy, sx2, sy2)
    valid = torch.arange(CAP, device=dev) < ROWS
    v1 = torch.from_numpy(rng.integers(1, 6, CAP).astype(np.int32)).to(dev)
    v2 = torch.from_numpy(rng.integers(1, 16, CAP).astype(np.int32)).to(dev)
    v1, v2 = v1 * valid, v2 * valid
    w1, w2 = v1.to(torch.int64), v2.to(torch.int64)
    shapes = {"q1": (11, (valid, v1)),
              "q9": (101, (valid, v1, v2, w1 * w2, w1 * w1, w2 * w2))}
    timed = {}
    for q, (dp, ls) in shapes.items():
        code = torch.where(valid, torch.from_numpy(
            rng.integers(0, dp - 1, CAP).astype(np.int32)).to(dev), dp - 1)
        if not torch.equal(K.onehot_segment_sums(code, ls, dp),
                           K.onehot_segment_sums_plain(code, ls, dp)):
            raise AssertionError(f"onehot_segment_sums differs at {q}")
        timed[q] = {
            "ms": cuda_ms(lambda: K.onehot_segment_sums(code, ls, dp)),
            "plain_ms": cuda_ms(
                lambda: K.onehot_segment_sums_plain(code, ls, dp))}
        print(f"# onehot_segment_sums at {q}'s shape (dp {dp}, "
              f"{len(ls)} lanes, {CAP} rows): kernel {timed[q]['ms']:.4f} "
              f"ms, plain {timed[q]['plain_ms']:.4f} ms (median of 10), "
              f"equal", flush=True)
    timed["q9"]["q1_ms"] = timed["q1"]["ms"]
    timed["q9"]["q1_plain_ms"] = timed["q1"]["plain_ms"]
    return err, timed


def check_running(rng, dev):
    """fused_running_stats against its plain version: {0, 1} values (float32
    sums exact below 2^24, so all three equal), normal values (sums within
    RUN_SUM_TOL of the running Σ|x| of a float64 cumsum, min and max
    equal), normal values with NaNs (NaN where the plain version has it),
    and best_profit equal to the plain computation."""
    x01 = torch.from_numpy(rng.integers(0, 2, CAP).astype(np.float32)).to(dev)
    for g, w in zip(K.fused_running_stats(x01),
                    K.fused_running_stats_plain(x01)):
        if not torch.equal(g, w):
            raise AssertionError("fused_running_stats differs on {0, 1}")
    xn = torch.from_numpy(rng.normal(size=CAP).astype(np.float32)).to(dev)
    xnan = xn.clone()
    xnan[torch.from_numpy(rng.random(CAP) < 1e-6).to(dev)] = float("nan")
    err = 0.0
    for x in (xn, xnan):
        got = K.fused_running_stats(x)
        want = K.fused_running_stats_plain(x)
        for g, w in zip(got, want):
            if not torch.equal(g.isnan(), w.isnan()):
                raise AssertionError("fused_running_stats: NaN rows differ")
        ok = ~got[0].isnan()
        exact = torch.cumsum(torch.nan_to_num(x).double(), 0)
        scale = torch.cumsum(torch.nan_to_num(x).double().abs(), 0)
        if not bool(((got[0].double() - exact).abs()[ok]
                     <= RUN_SUM_TOL * scale[ok]).all()):
            raise AssertionError("fused_running_stats sums out of tolerance")
        err = max(err, max_abs_err(got[0], want[0]))
        for g, w in zip(got[1:], want[1:]):
            if not torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)):
                raise AssertionError("fused_running_stats min/max differ")
    idx = torch.arange(CAP, device=dev)
    for n in (ROWS, CAP):
        bp = K.best_profit(xn, n)
        plain = torch.where(idx < n, xn - torch.cummin(xn, 0).values,
                            float("-inf")).max()
        if not torch.equal(bp, plain):
            raise AssertionError(f"best_profit {bp} vs plain {plain}")
    timed = {"ms": cuda_ms(lambda: K.fused_running_stats(xn)),
             "plain_ms": cuda_ms(lambda: K.fused_running_stats_plain(xn))}
    print(f"# fused_running_stats: kernel {timed['ms']:.4f} ms, plain "
          f"{timed['plain_ms']:.4f} ms (median of 10, {CAP} rows), max |err| "
          f"of the sums vs plain {err}; min, max and best_profit equal",
          flush=True)
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


def run_slice(dev) -> dict[str, dict[str, int]]:
    """The h2o queries and the computed-key query on G1_1e7_1e1_0_0."""
    data = h2o_g1(ROWS, K_GROUPS, SEED)
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
    K.build()
    phase("2. build")
    print(f"# built {K.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in K.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"# ptxas {line.strip()}")

    rows = check_kernels(dev)
    phase("3. kernels vs plain: equal")

    launches = run_slice(dev)
    launches.update(run_trades(dev))
    launches.update(run_nas(dev))
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
