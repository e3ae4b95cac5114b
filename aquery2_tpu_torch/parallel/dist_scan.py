"""Running scans across row-sharded columns: a local scan per rank, then
each rank's carry from the ranks before it.

Counterpart of ``aquery2_tpu/parallel/dist_scan.py``: the local scans are
ops/scan's (the seg_scan_multi and seg_cumsum_i64 kernels); one all_gather
of every rank's total gives each rank the combination of the totals of
the ranks before it, which it folds into its rows. Traffic: world values
per scan.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.ops import scan as S
from aquery2_tpu_torch.ops.reduce import big_of, small_of
from aquery2_tpu_torch.parallel import comm


def _carried(mesh, local: torch.Tensor, op: str) -> torch.Tensor:
    total = local[-1:] if local.shape[0] else \
        torch.full((1,), 0 if op == "add" else
                   (big_of(local.dtype) if op == "min"
                    else small_of(local.dtype)),
                   dtype=local.dtype, device=local.device)
    totals = comm.all_gather(mesh, total).reshape(-1)[:mesh.rank]
    if mesh.rank == 0:
        return local
    if op == "add":
        return local + totals.sum().to(local.dtype)
    if op == "min":
        return torch.minimum(local, totals.min())
    return torch.maximum(local, totals.max())


def dist_sums(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the running sum of the whole column."""
    return _carried(mesh, S.seg_cumsum(x.contiguous(), None), "add")


def dist_mins(mesh, x: torch.Tensor) -> torch.Tensor:
    return _carried(mesh, S.seg_cummin(x, None), "min")


def dist_maxs(mesh, x: torch.Tensor) -> torch.Tensor:
    return _carried(mesh, S.seg_cummax(x, None), "max")
