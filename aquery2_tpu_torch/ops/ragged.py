"""Ragged (CSR) helpers: variable-count expansion on the device.

Counterpart of ``aquery2_tpu/ops/ragged.py``: given per-bucket counts,
enumerate (bucket, within) pairs for a fixed output capacity with one
``searchsorted``; ``take`` reorders a ragged column (a VectorColumn's flat
values and offsets) by a row permutation.
"""

from __future__ import annotations

import torch


def expand(counts: torch.Tensor, total_cap: int, total: int):
    """Enumerate CSR items. counts: int [C] (padding buckets count 0).
    Returns (bucket_idx, within_idx, valid), each of shape [total_cap]:
    item k belongs to bucket bucket_idx[k] at offset within_idx[k]."""
    c = counts.to(torch.int64)
    ends = torch.cumsum(c, 0)
    starts = ends - c
    k = torch.arange(total_cap, dtype=torch.int64, device=counts.device)
    b = torch.searchsorted(starts, k, right=True) - 1
    b = b.clamp(0, counts.shape[0] - 1)
    return b, k - starts[b], k < total


def lengths_from_offsets(offsets: torch.Tensor) -> torch.Tensor:
    return offsets[1:] - offsets[:-1]


def take(values: torch.Tensor, offsets: torch.Tensor, perm: torch.Tensor,
         nrows: int, total_cap: int, total: int):
    """Reorder a ragged column by a row permutation: (new values
    [total_cap], new offsets [len(perm) + 1]). Rows of perm at or past
    nrows come out empty; total is the number of values they keep."""
    lens = lengths_from_offsets(offsets)[perm]
    idx = torch.arange(lens.shape[0], device=lens.device)
    lens = torch.where(idx < nrows, lens, 0)
    b, within, valid = expand(lens, total_cap, total)
    src = (offsets[perm[b]] + within).clamp(0, values.shape[0] - 1)
    out = torch.where(valid, values[src], torch.zeros((), dtype=values.dtype,
                                                      device=values.device))
    new_off = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    return out, new_off
