"""SQL window functions (OVER) in the sorted domain.

Counterpart of ``aquery2_tpu/ops/window.py``. The caller sorts the rows by
(partition keys, order keys) once, with one stable sort
(engine/eval.EvalContext._window); every frame aggregate here is then a
composition of segmented scans (ops/scan.py, so on the card the
seg_cumsum_i64 and seg_scan_multi kernels) and constant-offset gathers,
over all partitions at once: 1e6 partitions cost the passes one does.

Conventions (every tensor in the sorted domain, of the padded capacity):
  flags : bool, True at each partition start (flags[0] is True; the
          padding rows make a partition of their own, so nothing here
          needs the row count)
  pos   : each row's position within its partition (int32)
  x     : the argument, with NULL rows set to the op's identity
  ind   : True where the row is not NULL (False at padding and NULLs)
  lo/hi : frame offsets from the current row (Python ints), None where
          the frame is unbounded on that side
Results at padding rows are unspecified; the caller scatters back only
the real rows.

The reverse-domain scans (``last_index``, and ``frame_extreme`` when hi is
unbounded or both sides are bounded) flip their inputs and outputs, as
the JAX package does: each flip is a full copy here.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops.scan import (_fp_dtype, _long_dtype,
                                        _slide_extreme, seg_cummax,
                                        seg_cummin, seg_cumsum)
from aquery2_tpu_torch.ops.segment import last_flags, pos_from_flags

__all__ = [
    "positions", "is_last_from_flags", "first_index", "last_index",
    "frame_bounds", "frame_sum_count", "frame_moments", "frame_extreme",
]


def positions(flags: torch.Tensor) -> torch.Tensor:
    return pos_from_flags(flags)


def is_last_from_flags(flags: torch.Tensor) -> torch.Tensor:
    """True at each partition's final row."""
    return last_flags(flags)


def _bcast_first(v: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """v at each segment start, broadcast over the segment (v >= 0)."""
    return seg_cummax(torch.where(flags, v, -1), flags)


def first_index(flags: torch.Tensor) -> torch.Tensor:
    """Index of each row's segment start (int32)."""
    idx = torch.arange(flags.shape[0], dtype=torch.int32, device=flags.device)
    return _bcast_first(idx, flags)


def last_index(flags: torch.Tensor) -> torch.Tensor:
    """Index of each row's segment end (int32), by a broadcast in the
    reversed domain."""
    idx = torch.arange(flags.shape[0], dtype=torch.int32, device=flags.device)
    rflags = torch.flip(is_last_from_flags(flags), (0,))
    return torch.flip(_bcast_first(torch.flip(idx, (0,)), rflags), (0,))


def frame_bounds(start: torch.Tensor, last: torch.Tensor, lo: int | None,
                 hi: int | None, lo_idx: torch.Tensor | None = None,
                 hi_idx: torch.Tensor | None = None):
    """Each row's inclusive frame [lo_i, hi_i] clamped to its partition
    (int64), and ``empty``, True where the frame lies wholly outside it.
    start/last: each row's partition's first and last row (int64; the
    JAX package's frame_bounds computes them from the flags, which the
    caller here has already done). lo_idx/hi_idx give explicit row
    indices in place of the offsets (RANGE's peer bounds)."""
    idx = torch.arange(start.shape[0], dtype=torch.int64, device=start.device)
    if lo_idx is not None:
        lo_r = lo_idx.to(torch.int64)
    else:
        lo_r = start if lo is None else idx + lo
    if hi_idx is not None:
        hi_r = hi_idx.to(torch.int64)
    else:
        hi_r = last if hi is None else idx + hi
    empty = (lo_r > hi_r) | (hi_r < start) | (lo_r > last)
    lo_i = torch.minimum(torch.maximum(lo_r, start), last)
    hi_i = torch.minimum(torch.maximum(hi_r, start), last)
    return lo_i, hi_i, empty


def frame_sum_count(x: torch.Tensor, ind: torch.Tensor, flags: torch.Tensor,
                    lo_i: torch.Tensor, hi_i: torch.Tensor):
    """(sum, count) over [lo_i, hi_i] from segment-local prefix sums,
    S[hi] - S[lo] + x[lo]: integer sums and the count in int64 (exact),
    float sums in float64. Both bounds lie in the row's partition
    (frame_bounds sees to it)."""
    xl = x.to(_long_dtype(x.dtype))
    S = seg_cumsum(xl, flags)
    indl = ind.to(torch.int64)
    C = seg_cumsum(indl, flags)
    return S[hi_i] - S[lo_i] + xl[lo_i], C[hi_i] - C[lo_i] + indl[lo_i]


def frame_moments(x: torch.Tensor, ind: torch.Tensor, flags: torch.Tensor,
                  lo_i: torch.Tensor, hi_i: torch.Tensor):
    """(sum, sum of squares, count) in float64 over each frame, for avg,
    var and stddev (x zeroed at NULLs, ind False there): three add lanes
    of one seg_scan_multi call."""
    fp = _fp_dtype(x.dtype)
    xf = x.to(fp)
    ones = ind.to(fp)
    sq = xf * xf
    S, Q, C = K.seg_scan_multi(flags.contiguous(),
                               (xf.contiguous(), sq, ones),
                               ("add", "add", "add"))
    return (S[hi_i] - S[lo_i] + xf[lo_i], Q[hi_i] - Q[lo_i] + sq[lo_i],
            C[hi_i] - C[lo_i] + ones[lo_i])


def frame_extreme(x: torch.Tensor, flags: torch.Tensor, pos: torch.Tensor,
                  lo: int | None, hi: int | None, op,
                  lo_i: torch.Tensor, hi_i: torch.Tensor) -> torch.Tensor:
    """min or max (op: torch.minimum or torch.maximum) over each frame,
    from scans in three regimes:

    * lo unbounded: the running extreme, read at hi_i;
    * hi unbounded: the running extreme of the reversed rows, read at
      lo_i;
    * both bounded with lo <= 0 <= hi: a forward slide over [i + lo, i]
      combined with a reversed slide over [i, i + hi] (they overlap at
      i, which an idempotent op allows). A frame without the current row
      is the caller's to reject.

    x carries the op's identity at NULL and padding rows."""
    cum = seg_cummin if op is torch.minimum else seg_cummax
    if lo is None:
        return cum(x, flags)[hi_i]
    if hi is None:
        rflags = torch.flip(is_last_from_flags(flags), (0,))
        return torch.flip(cum(torch.flip(x, (0,)), rflags), (0,))[lo_i]
    if not lo <= 0 <= hi:
        raise ValueError("bounded min/max frame must contain the current row")
    fwd = _slide_extreme(-lo + 1, x, pos, op)
    if hi == 0:
        return fwd
    rflags = torch.flip(is_last_from_flags(flags), (0,))
    rpos = pos_from_flags(rflags)
    bwd = torch.flip(_slide_extreme(hi + 1, torch.flip(x, (0,)), rpos, op),
                     (0,))
    return op(fwd, bwd)
