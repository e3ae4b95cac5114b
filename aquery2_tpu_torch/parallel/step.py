"""One combined distributed step over every collective pattern.

Counterpart of ``aquery2_tpu/parallel/step.py``: on this rank's rows,

  1. dense grouped sums, one all_reduce per dtype   (dist_groupby)
  2. the shuffle group-by                           (dist_groupby)
  3. the exchanged join's pair count                (dist_join)
  4. a running sum carried across ranks             (dist_scan)
"""

from __future__ import annotations

import numpy as np
import torch

from aquery2_tpu_torch.parallel import dist_groupby, dist_join, dist_scan


def distributed_query_step(mesh, codes, v1, v3, time_col, lkey, rkey,
                           domain: int):
    """(group counts [domain], group sums of v1 and v3 [domain], this
    rank's shuffle groups (codes, counts, sums), the join's pair count,
    this rank's rows of the running sum of time_col)."""
    valid = torch.ones(codes.shape, dtype=torch.bool, device=codes.device)
    counts, sums, fsums = dist_groupby.dist_grouped_sums(
        mesh, codes, [v1, v3], valid, domain)
    shuffled = dist_groupby.dist_grouped_sums_shuffle(mesh, codes, [v1],
                                                      valid)
    pairs = dist_join.dist_join_counts(mesh, lkey, valid, rkey, valid)
    running = dist_scan.dist_sums(mesh, time_col)
    return counts, sums, fsums, shuffled, pairs, running


def make_example(mesh, rows_per_rank: int = 256, domain: int = 32,
                 device="cpu"):
    """This rank's rows of small seeded example inputs (the whole columns
    are made on every rank from seed 0, then sliced)."""
    n = mesh.world * rows_per_rank
    rng = np.random.default_rng(0)
    cols = [rng.integers(0, domain, n).astype(np.int32),
            rng.integers(0, 5, n).astype(np.int64),
            rng.integers(0, 7, n).astype(np.int32),
            rng.integers(0, 100, n).astype(np.int64),
            rng.integers(0, 64, n).astype(np.int64),
            rng.integers(0, 64, n).astype(np.int64)]
    lo = mesh.rank * rows_per_rank
    return [torch.from_numpy(c[lo:lo + rows_per_rank]).to(device)
            for c in cols]
