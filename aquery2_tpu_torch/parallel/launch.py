"""Spawn a world of ranks on this machine and run one function on each.

The port's stand-in for the JAX package's virtual 8-device mesh
(``tests/conftest.py``) and its two-process launch
(``tests/test_multihost.py``): ``run(fn, world, *args)`` starts ``world``
processes with the ``spawn`` start method, joins them in one process
group through a ``file://`` rendezvous in a temporary directory, sets one
intra-op thread per rank, calls ``fn(rank, world, *args)`` on each and
returns rank 0's value. fn must be importable by name (a module-level
function) and its value picklable.

Failure is loud and bounded: a rank that raises ends the world, and
``run`` raises RankFailed with that rank's traceback; a world that has not
finished ``timeout_s`` seconds after it started is killed and ``run``
raises RankFailed too. The process group's own timeout is the same, so a
rank blocked in a collective whose partner died gives up as well.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


class RankFailed(RuntimeError):
    """A rank of a spawned world raised, or the world ran out of time."""


def _rank_main(rank, world, path, backend, timeout_s, q, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{path}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        value = fn(rank, world, *args)
        q.put((rank, True, value))
    except BaseException:                       # noqa: BLE001 — reported
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:                   # noqa: BLE001
                pass


def run(fn, world: int, *args, backend: str = "gloo",
        timeout_s: float = 90.0):
    """fn(rank, world, *args) on each of ``world`` fresh ranks; rank 0's
    value."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="aq_world_") as tmp:
        path = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, path, backend, timeout_s, q, fn,
                                   args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 15
        values: dict[int, object] = {}
        try:
            while len(values) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RankFailed(
                        f"world of {world} ranks timed out after "
                        f"{timeout_s:.0f} s; finished: {sorted(values)}")
                try:
                    rank, ok, value = q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in values]
                    if dead:
                        raise RankFailed(f"rank {dead[0]} died with exit "
                                         f"code {procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RankFailed(f"rank {rank} raised:\n{value}")
                values[rank] = value
        finally:
            for p in procs:
                p.join(timeout=5 if len(values) == world else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return values[0]
