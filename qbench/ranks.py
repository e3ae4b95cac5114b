"""One run of a cell over N ranks: a mesh session of the program, one
process and one device a rank.

``run.py`` calls ``run`` for a cell whose ``chips`` exceed 1, with
cuda:0 to cuda:N-1 and the program's default backend (NCCL on CUDA). The
launcher loads the kernel library once (so that the ranks do not build
it at the same time into one directory), then spawns N ranks with the
``spawn`` start method. Rank r runs ``harness.run`` on its device with a
``World``: its session is ``connect(device, mesh=N,
coordinator="file://<tmp>/rendezvous", num_processes=N, process_id=r)``,
each rank makes the same tables from the seed and places them
(``Session.place_table``), all ranks run the same warm-up and then the
same whole mixes in lockstep (``World.agree``: rank 0 decides after each
mix), rank 0's host clock times the queries, and rank 0 copies the
sampled answers out and checks them once every rank has freed its state.

Readings: the memory peaks are the fullest rank's; with a trace, the
per-layer metrics read rank 0's window, but for the device's busy time
and the window's length, which are the ranks' means (so
``device.idle_share`` is the mean idle share of the N devices).

Only the launcher writes to standard output (each rank's is its standard
error). A rank that raises or dies ends the world at once: the launcher
kills the other ranks, logs the traceback, and returns a result that is
not correct. A world still running at its deadline (set-up, the window,
the check, and the process group's timeout) is killed and ``run``
raises WorldTimeout.

Imports nothing of the program but what ``harness.py`` and the kernel
library's loader do; the spawn is the benchmark's own, so that it does
not move when a helper of the program does.
"""

from __future__ import annotations

import os
import queue
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from qbench import harness

SETUP_S = 300           # a world's set-up: imports, tables, placement, warm-up
CHECK_S = 300           # rank 0's check against the reference
GROUP_TIMEOUT_S = 300   # the program's process-group timeout (multihost)


class WorldTimeout(RuntimeError):
    """The world ran past its deadline and was killed."""


@dataclass
class World:
    """One rank's place in the world, and the few collectives the harness
    itself makes (the program's own go through its session)."""
    rank: int
    size: int
    device: torch.device
    rendezvous: str
    backend: str | None

    def connect_args(self) -> dict:
        """connect()'s arguments for this rank's mesh session."""
        return {"mesh": self.size,
                "coordinator": f"file://{self.rendezvous}",
                "num_processes": self.size, "process_id": self.rank,
                "backend": self.backend}

    def _on_nccl(self) -> bool:
        return dist.get_backend() == "nccl"

    def barrier(self) -> None:
        if self._on_nccl():
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def agree(self, go: bool) -> bool:
        """Rank 0's go, on every rank."""
        flag = torch.tensor([int(go)], dtype=torch.int32,
                            device=self.device if self._on_nccl() else "cpu")
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def combine(self, peak: int, setup_peak: int, window) -> tuple[int, int]:
        """The fullest rank's memory peaks (the window's, the set-up's);
        window's busy_s and window_s become the ranks' means."""
        got = [None] * self.size
        dist.all_gather_object(got, (peak, setup_peak, window.busy_s,
                                     window.window_s))
        window.busy_s = sum(g[2] for g in got) / self.size
        window.window_s = sum(g[3] for g in got) / self.size
        return max(g[0] for g in got), max(g[1] for g in got)


def _rank_main(rank, size, device, backend, rendezvous, cell, seed, seconds,
               traced, t_start, q, rank_setup):
    """One rank: harness.run with its World; puts (rank, "done", result or
    None, forbidden modules) or (rank, "raised", traceback) on q."""
    os.dup2(2, 1)                   # standard output is the launcher's
    try:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // size))
        if rank_setup is not None:
            rank_setup(rank, size)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        world = World(rank, size, device, rendezvous, backend)
        out = harness.run(
            cell, seed, seconds, traced, device, t_start, world=world,
            log=lambda msg: print(f"[rank {rank}] {msg}", file=sys.stderr,
                                  flush=True))
        q.put((rank, "done", out, harness.forbidden_modules()))
    except Exception:               # reported: the launcher ends the world
        q.put((rank, "raised", traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def failed_result(cell, devices) -> dict:
    """The result line of a world that ended early: not correct, one
    failure, no metrics."""
    on_card = devices[0].type == "cuda"
    return {"correct": False, "attempted": 1, "failed": 1, "metrics": {},
            "device": {"platform": "gpu" if on_card else "cpu",
                       "kind": (torch.cuda.get_device_name(devices[0])
                                if on_card else "cpu"),
                       "count": cell.workload["chips"],
                       "memory_peak_bytes": 0},
            "checks": {"ranks_failed": {"value": 1, "limit": 0}}}


def run(cell, seed: int, seconds: float, traced: bool, devices: list,
        backend: str | None, t_start: float, log=None, rank_setup=None,
        deadline_s: float | None = None) -> tuple[dict, list[str]]:
    """One run of cell over len(devices) ranks, rank r on devices[r]
    (devices may repeat one card, with the gloo backend). Returns rank 0's
    result line's object (or failed_result's) and the forbidden modules
    loaded in any rank or here. rank_setup(rank, size), where given, is
    called first in each rank (an importable function)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    size = len(devices)
    if deadline_s is None:
        deadline_s = SETUP_S + seconds + CHECK_S + GROUP_TIMEOUT_S
    if devices[0].type == "cuda":
        from aquery2_tpu_torch.ops import kernels as K
        K.build()
        log(f"# kernels loaded ({time.perf_counter() - t_start:.1f} s); "
            f"spawning {size} ranks")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    done: dict[int, tuple] = {}
    with tempfile.TemporaryDirectory(prefix="qbench_world_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            r, size, devices[r], backend, os.path.join(tmp, "rendezvous"),
            cell, seed, seconds, traced, t_start, q, rank_setup), daemon=True)
            for r in range(size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + deadline_s
        why = None
        try:
            while len(done) < size and why is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise WorldTimeout(
                        f"the world of {size} ranks ran past its deadline "
                        f"of {deadline_s:.0f} s; finished: {sorted(done)}")
                try:
                    rank, what, value, bad = q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in done]
                    if dead:
                        why = (f"rank {dead[0]} died with exit code "
                               f"{procs[dead[0]].exitcode}")
                    continue
                if what == "raised":
                    why = f"rank {rank} raised"
                    log(f"# {why}:\n{value}")
                else:
                    done[rank] = (value, bad)
        finally:
            for p in procs:
                p.join(timeout=5 if len(done) == size else 0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    bad = sorted(set(harness.forbidden_modules()).union(
        *(b for _, b in done.values())))
    if why is not None:
        log(f"# the world ended early: {why}")
        return failed_result(cell, devices), bad
    return done[0][0], bad
