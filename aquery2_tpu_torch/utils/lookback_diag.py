"""Diagnostics of the single-pass scans (csrc/segscan.cuh) on one CUDA
card: how many blocks an SM holds, where a block's time goes, and how the
tile's shared-memory budget moves the kernel's time. The scans are
seg_cumsum_i64, seg_scan_multi and fused_running_stats.

    python -m aquery2_tpu_torch.utils.lookback_diag [--out DIR]

Run from the root of a checkout: it builds variants of the kernels'
library beside the plain one (build/aquery2_tpu_torch/), all at once. At
the main path's shapes (12,582,912 rows, flag density 0.1; the int64 sum
also without flags, where the look-back walks to an inclusive prefix, and
fused_running_stats, which has no flags):
  1. per single-pass instantiation, ptxas' registers, spills, stack and
     static shared memory, its threads and dynamic shared memory (as the
     library's aq_<scan>_block reports its launch), and the blocks an SM
     could hold by each of its limits;
  2. a build with -DAQ_LOOKBACK_DIAG, whose blocks record per tile their
     SM and clock64() at entry, once loaded, once scanned, after the
     look-back and once written: the blocks an SM held on average (the
     sum of its blocks' cycles over its first-to-last span: achieved
     occupancy), each phase's share of a block's cycles, the look-back's
     cycles and windows, and the instrumented kernel's time beside the
     plain build's;
  3. builds with -DAQ_LOOKBACK_SMEM=<bytes> for each of BUDGETS: rows
     per tile and device time, in two passes (the budgets in turn, then
     in reverse).
Times are CUDA events, median of 10, each run queued behind a
torch.cuda._sleep so that they time the device alone. Prints one line
per measurement; with --out, also writes them to DIR/lookback_diag.json.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from aquery2_tpu_torch.ops import kernels as K

CAP = 12_582_912                 # config.bucket_size(1e7)
SEED = 42
DENSITY = 0.1
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
REGS_PER_SM, THREADS_PER_SM, BLOCKS_PER_SM = 65536, 2048, 32
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 233472, 1024    # sm_90, bytes
DIAG = ("-DAQ_LOOKBACK_DIAG",)
DEFAULT_BUDGET = 47104           # segscan.cuh AQ_LOOKBACK_SMEM
BUDGETS = (12288, 16384, 24576, 32768, 40960, DEFAULT_BUDGET)
SLEEP_CYCLES = 2_000_000
# (label, kernel, lanes, ops (seg_scan_multi only), flags, its name in
# kernels.ptxas_report)
SHAPES = [
    ("seg_cumsum_i64, 1 x int64", "seg_cumsum_i64", ("x64",), None, True,
     "seg_cumsum_i64, flags 1"),
    ("seg_cumsum_i64, 1 x int64, no flags", "seg_cumsum_i64", ("x64",),
     None, False, "seg_cumsum_i64, flags 0"),
    ("seg_scan_multi, q7: int32 min + int32 max", "seg_scan_multi",
     ("v2", "v1"), ("min", "max"), True, "seg_scan_multi 2 x 32-bit, flags 1"),
    ("seg_scan_multi, q8: 1 x int32 add", "seg_scan_multi", ("ones",),
     ("add",), True, "seg_scan_multi 1 x 32-bit, flags 1"),
    ("seg_scan_multi, 3 x 32-bit", "seg_scan_multi", ("xi", "xf", "xa"),
     ("max", "min", "add"), True, "seg_scan_multi 3 x 32-bit, flags 1"),
    ("seg_scan_multi, max_stddevs: 2 x float64 add", "seg_scan_multi",
     ("xd", "xint"), ("add", "add"), True,
     "seg_scan_multi 2 x 64-bit, flags 1"),
    ("seg_scan_multi, 3 x 64-bit", "seg_scan_multi", ("x64", "xd", "xd"),
     ("max", "min", "add"), True, "seg_scan_multi 3 x 64-bit, flags 1"),
    ("fused_running_stats, 1 x float32 in, 3 out, no flags",
     "fused_running_stats", ("xf",), None, False,
     "fused_running_stats 3 x float32, one input"),
]


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def columns(dev, n: int = CAP) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(SEED)

    def col(a):
        return torch.from_numpy(a).to(dev)
    return {
        "flags": col(rng.random(n) < DENSITY),
        "x64": col(rng.integers(-2**62, 2**62, n)),
        "v1": col(rng.integers(1, 6, n).astype(np.int32)),
        "v2": col(rng.integers(1, 16, n).astype(np.int32)),
        "ones": torch.ones(n, dtype=torch.int32, device=dev),
        "xi": col(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)),
        "xf": col(rng.normal(size=n).astype(np.float32)),
        "xa": col(rng.integers(0, 2, n).astype(np.float32)),
        "xd": col(rng.normal(size=n) * 1e3),
        "xint": col(rng.integers(-2**20, 2**20, n).astype(np.float64)),
    }


class Shape:
    """One main-path call: its kernel call, bytes and tile geometry (the
    geometry as the library reports it)."""

    def __init__(self, label, kernel, lanes, ops, flagged, name, cols):
        self.label, self.kernel, self.ops, self.name = label, kernel, ops, name
        self.flags = cols["flags"] if flagged else None
        self.xs = tuple(cols[c] for c in lanes)

    def call(self):
        if self.kernel == "seg_scan_multi":
            return K.seg_scan_multi(self.flags, self.xs, self.ops)
        if self.kernel == "fused_running_stats":
            return K.fused_running_stats(self.xs[0])
        return K.seg_cumsum_i64(self.flags, self.xs[0])

    def nbytes(self) -> int:
        """Every input read once, every output the call returns written
        once, the flags 1 B/row."""
        out = self.call()
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return sum(t.numel() * t.element_size() for t in (*self.xs, *outs)
                   ) + (0 if self.flags is None else self.flags.numel())

    def _entry(self, lib, what: str):
        """The library's aq_<kernel>_<what> and its leading arguments."""
        args = ((len(self.xs), int(self.xs[0].element_size() == 8))
                if self.kernel == "seg_scan_multi" else ())
        return getattr(lib, f"aq_{self.kernel}_{what}"), args

    def rows(self, lib) -> int:
        fn, args = self._entry(lib, "tile_rows")
        return fn(*args)

    def block(self, lib) -> tuple[int, int]:
        """Threads and bytes of dynamic shared memory of one block."""
        fn, args = self._entry(lib, "block")
        out = (ctypes.c_int * 2)()
        rc = fn(*args, out)
        if rc:
            raise RuntimeError(f"reading the block of {self.name} failed: {rc}")
        return out[0], out[1]

    def records(self, lib) -> np.ndarray:
        ntiles = -(-CAP // self.rows(lib))
        out = np.zeros((ntiles, 8), np.int64)
        read = getattr(lib, f"aq_{self.kernel}_lookback_diag")
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        read.restype = ctypes.c_int
        rc = read(out.ctypes.data, ntiles)
        if rc:
            raise RuntimeError(f"reading the records failed: {rc}")
        return out


def timed(lib, shape: Shape) -> float:
    with mock.patch.object(K, "build", lambda *a: lib):
        return cuda_ms(shape.call)


def occupancy_limits(r: dict, threads: int, dyn_smem: int) -> dict:
    """Blocks an SM could hold by registers, shared memory and threads."""
    warps = threads // 32
    per_warp = -(-r["registers"] * 32 // 256) * 256
    return {"by_registers": REGS_PER_SM // (per_warp * warps),
            "by_shared_memory": SMEM_PER_SM // (
                dyn_smem + r["smem"] + SMEM_PER_BLOCK_RESERVED),
            "by_threads": THREADS_PER_SM // threads,
            "max": BLOCKS_PER_SM}


def summarize(rec: np.ndarray, threads: int) -> dict:
    """Achieved occupancy and phase shares from a launch's tile records:
    [sm, entry, loaded, scanned, looked back, written, windows, threads]."""
    sm, c = rec[:, 0], rec[:, 1:6].astype(np.float64)
    block = c[:, 4] - c[:, 0]
    resident = []
    for s in np.unique(sm):
        on = sm == s
        span = c[on, 4].max() - c[on, 0].min()
        resident.append(block[on].sum() / span)
    phases = np.diff(c, axis=1).sum(0) / block.sum()
    walk = c[1:, 3] - c[1:, 2]                 # tile 0 has no look-back
    blocks = float(np.mean(resident))
    return {
        "tiles": int(len(rec)), "sms": int(len(resident)),
        "resident_blocks_per_sm": blocks,
        "achieved_warp_occupancy": blocks * threads / 32 / 64,
        "share_load": float(phases[0]), "share_fold_scan": float(phases[1]),
        "share_look_back": float(phases[2]),
        "share_rescan_store": float(phases[3]),
        "block_cycles_mean": float(block.mean()),
        "look_back_cycles_mean": float(walk.mean()),
        "look_back_cycles_p99": float(np.percentile(walk, 99)),
        "look_back_cycles_max": float(walk.max()),
        "windows_mean": float(rec[1:, 6].mean()),
        "windows_max": int(rec[1:, 6].max()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lookback_diag: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True
                          ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    variants = {"plain": (), "diag": DIAG}
    variants.update({b: (f"-DAQ_LOOKBACK_SMEM={b}",) for b in BUDGETS
                     if b != DEFAULT_BUDGET})
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(K.build, variants.values())))
    libs[DEFAULT_BUDGET] = libs["plain"]
    dev = torch.device("cuda", 0)
    cols = columns(dev)
    shapes = [Shape(*s, cols) for s in SHAPES]
    report = {"card": card, "rows": CAP, "density": DENSITY,
              "ptxas": [], "diag": [], "budgets": []}

    ptxas = {r["kernel"]: r for r in K.ptxas_report()}
    for sh in shapes:
        if sh.name in (p["name"] for p in report["ptxas"]):
            continue
        r = ptxas[sh.name]
        threads, dyn = sh.block(libs["plain"])
        row = {"name": sh.name, **r, "threads": threads,
               "dynamic_smem": dyn,
               **occupancy_limits(r, threads, dyn)}
        report["ptxas"].append(row)
        print(f"# ptxas {sh.name}: {r['registers']} registers, "
              f"{r['spill_stores']}/{r['spill_loads']} B spill stores/loads, "
              f"{r['stack']} B stack, {r['smem']} B static + {dyn} B dynamic "
              f"shared memory, {threads} threads; blocks an SM could hold: "
              f"{row['by_registers']} by registers, "
              f"{row['by_shared_memory']} by shared memory, "
              f"{row['by_threads']} by threads", flush=True)

    for sh in shapes:
        plain_ms = timed(libs["plain"], sh)
        diag_ms = timed(libs["diag"], sh)
        with mock.patch.object(K, "build", lambda *a: libs["diag"]):
            sh.call()
        torch.cuda.synchronize()
        s = summarize(sh.records(libs["diag"]), sh.block(libs["diag"])[0])
        s.update(shape=sh.label, plain_ms=plain_ms, diag_ms=diag_ms)
        report["diag"].append(s)
        print(f"# {sh.label}: {s['resident_blocks_per_sm']:.2f} blocks "
              f"resident per SM ({s['achieved_warp_occupancy']:.1%} of the "
              f"warps); a block's cycles: load {s['share_load']:.1%}, fold "
              f"and scan {s['share_fold_scan']:.1%}, look-back "
              f"{s['share_look_back']:.1%}, rescan and store "
              f"{s['share_rescan_store']:.1%} (mean "
              f"{s['block_cycles_mean']:.0f} cycles); look-back mean "
              f"{s['look_back_cycles_mean']:.0f}, p99 "
              f"{s['look_back_cycles_p99']:.0f}, max "
              f"{s['look_back_cycles_max']:.0f} cycles, windows mean "
              f"{s['windows_mean']:.3f}, max {s['windows_max']}; time "
              f"{plain_ms:.4f} ms, {diag_ms:.4f} ms instrumented",
              flush=True)

    # two passes, the budgets in turn and then in reverse, so that a drift
    # of the card's clock shows as a spread between them
    bounds = {sh.label: sh.nbytes() / HBM_BYTES_PER_S * 1e3 for sh in shapes}
    for rep, order in enumerate((BUDGETS, BUDGETS[::-1])):
        for sh in shapes:
            for b in order:
                ms = timed(libs[b], sh)
                bound = bounds[sh.label]
                row = {"pass": rep, "budget": b, "shape": sh.label,
                       "rows": sh.rows(libs[b]),
                       "threads": sh.block(libs[b])[0], "ms": ms,
                       "share_of_bound": bound / ms}
                report["budgets"].append(row)
                print(f"# pass {rep}, budget {b} B, {sh.label}: "
                      f"{row['rows']} rows a tile, {row['threads']} threads, "
                      f"{ms:.4f} ms, {bound / ms:.1%} of bound", flush=True)

    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "lookback_diag.json").write_text(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
