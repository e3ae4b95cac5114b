"""Segmented running sum, min and max.

Counterpart of ``seg_cumsum``/``seg_cummin``/``seg_cummax`` in
``aquery2_tpu/ops/scan.py``: int64 sums go to the seg_cumsum_i64 kernel,
int32/float32 lanes to seg_scan_multi (ops/kernels.py). The running
aggregates built on them (sums/mins/maxs/avgs/vars under ASSUMING) wait
for the ordered path, ROADMAP queue 1, item 5.

flags: bool tensor, True where a segment starts (row 0 always starts
one), or None for one unsegmented scan.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.ops import kernels as K


def _unsupported(x: torch.Tensor, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of {x.dtype}: ROADMAP queue 1, item 5 (ordered path)")


def seg_cumsum(x: torch.Tensor, flags: torch.Tensor | None) -> torch.Tensor:
    if x.dtype == torch.int64:
        return K.seg_cumsum_i64(flags, x)
    if x.dtype in (torch.int32, torch.float32):
        return K.seg_scan_multi(flags, (x,), ("add",))[0]
    raise _unsupported(x, "seg_cumsum")


def seg_cummin(x: torch.Tensor, flags: torch.Tensor | None) -> torch.Tensor:
    if x.dtype in (torch.int32, torch.float32):
        return K.seg_scan_multi(flags, (x,), ("min",))[0]
    raise _unsupported(x, "seg_cummin")


def seg_cummax(x: torch.Tensor, flags: torch.Tensor | None) -> torch.Tensor:
    if x.dtype in (torch.int32, torch.float32):
        return K.seg_scan_multi(flags, (x,), ("max",))[0]
    raise _unsupported(x, "seg_cummax")
