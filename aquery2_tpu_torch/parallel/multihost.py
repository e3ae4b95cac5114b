"""Joining the process group: one engine spanning N ranks.

Counterpart of ``aquery2_tpu/parallel/multihost.py``. Every rank calls
``initialize`` with the same coordinator before its session places a
table; afterwards the default ``torch.distributed`` group holds the world
and ``connect(mesh=N)`` builds its mesh over it (parallel/mesh.py).

Launch (each rank, the same program):

    AQ_COORDINATOR=host0:1234 AQ_NUM_PROCESSES=4 AQ_PROCESS_ID=<r> \\
        python -m aquery2_tpu_torch ...
    # or: aq.connect(mesh=4, coordinator="host0:1234", num_processes=4,
    #                process_id=r, backend="nccl")
    # or under torchrun, whose MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
    # RANK give the env:// rendezvous

SPMD contract: every rank issues the SAME statements in the same order
over the same host data, as the JAX package's multi-controller model
asks. Every query result is whole on every rank.

The backend is the caller's: "nccl" wants one GPU per rank, "gloo" runs
on the CPU and lets several ranks share one card (the comm layer stages
gloo's collectives of CUDA tensors through host memory). The default is
nccl for a CUDA device and gloo for the CPU; nothing falls back from one
to the other.
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as dist

TIMEOUT_S = 300


def default_backend(device) -> str:
    return "nccl" if str(device).startswith("cuda") else "gloo"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device="cuda",
               timeout_s: float = TIMEOUT_S) -> bool:
    """Join the default process group (a no-op where it exists). The
    arguments fall back to AQ_COORDINATOR / AQ_NUM_PROCESSES /
    AQ_PROCESS_ID, then to torchrun's env:// variables. Returns whether
    a group exists afterwards."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("AQ_COORDINATOR")
    if num_processes is None and os.environ.get("AQ_NUM_PROCESSES"):
        num_processes = int(os.environ["AQ_NUM_PROCESSES"])
    if process_id is None and os.environ.get("AQ_PROCESS_ID") is not None:
        process_id = int(os.environ["AQ_PROCESS_ID"])
    backend = backend or default_backend(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        method = (coordinator if "://" in coordinator
                  else f"tcp://{coordinator}")
        dist.init_process_group(backend, init_method=method,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
        return True
    if all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                     "WORLD_SIZE", "RANK")):
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return True
    return False
