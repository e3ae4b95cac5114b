"""Segment bookkeeping for grouped and ordered computation.

Counterpart of ``aquery2_tpu/ops/segment.py``. After a group-by sort, rows
are ordered by group; a *segment* is one group's contiguous run. The
running and windowed aggregates of ops/scan.py take ``pos``, each row's
position within its segment, so one code path serves whole-column windows
(one segment) and per-group windows.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.ops import kernels as K


def flags_from_segment_ids(seg_ids: torch.Tensor) -> torch.Tensor:
    """True at each segment start. seg_ids must be non-decreasing."""
    prev = torch.cat([seg_ids[:1] - 1, seg_ids[:-1]])
    return seg_ids != prev


def pos_from_flags(flags: torch.Tensor) -> torch.Tensor:
    """int32 position within the segment from the start flags (row 0
    always starts one): one segmented int32 add of ones through
    seg_scan_multi, minus 1."""
    ones = torch.ones(flags.shape, dtype=torch.int32, device=flags.device)
    return K.seg_scan_multi(flags.contiguous(), (ones,), ("add",))[0] - 1


def last_flags(flags: torch.Tensor) -> torch.Tensor:
    """True at each segment end (the row before the next start, and the
    final row)."""
    return torch.cat([flags[1:], flags.new_ones(1)])
