"""Segmented scans and the running and windowed aggregates built on them.

Counterpart of ``aquery2_tpu/ops/scan.py``. The primitive scans go to the
hand kernels (ops/kernels.py): int64 sums to seg_cumsum_i64; int32,
float32 and float64 sums and every min/max to seg_scan_multi. The JAX
package leaves the 64-bit cases to XLA's doubling; here they take the
kernel too. On top of them, the AQuery time-series functions under
ASSUMING (``RUNNING``: sums, avgs, mins, maxs, vars, stddevs, ratios,
deltas, prev, next; ``WINDOWED``: their trailing-w forms) with the JAX
package's dtype rules: integer sums widen to int64, float sums and every
average, variance and ratio to float64. The shifted reads (deltas, prev,
next, the windowed differences) and the minw/maxw doubling are plain
torch ops, as they are XLA ops in the JAX package.

flags: bool tensor, True where a segment starts (row 0 always starts
one), or None for one unsegmented scan. pos: each row's position within
its segment (ops/segment.pos_from_flags). First-element semantics follow
the reference: sums[0]=x0, avgs[0]=x0, deltas[0]=0, prev[0]=x0,
next[last]=x[last], ratios[0]=x0/x0, vars[0]=0. Outputs at padding rows
are unspecified.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops.segment import last_flags

_SCAN_32 = (torch.int32, torch.float32)     # seg_scan_multi's 32-bit words
_SCAN_64 = (torch.int64, torch.float64)     # and its 64-bit words


def _long_dtype(dt: torch.dtype) -> torch.dtype:
    """Sum accumulator dtype: bool and integers → int64, floats → float64."""
    return torch.float64 if dt.is_floating_point else torch.int64


def _fp_dtype(dt: torch.dtype) -> torch.dtype:
    """Average/variance dtype: float32 → float64, as the reference promotes
    through GetLongType to double; other non-float dtypes → float64."""
    return dt if dt.is_floating_point and dt != torch.float32 \
        else torch.float64


def _shift_right(x: torch.Tensor, s: int) -> torch.Tensor:
    """x[i - s], wrapped in the first s rows (callers mask with pos >= s)."""
    return torch.roll(x, s, 0)


# --- segmented primitive scans --------------------------------------------

def seg_extremes(flags: torch.Tensor | None,
                 lanes: list[tuple]) -> dict[str, torch.Tensor]:
    """Segmented running min/max of (tag, column, op) lanes through
    seg_scan_multi: one call per 4 lanes of one word width. bool, int8,
    int16 and uint8 lanes widen to int32 and come back in their dtype."""
    by_width: dict[int, list[tuple]] = {4: [], 8: []}
    for t, col, op in lanes:
        dt = col.dtype
        if dt not in _SCAN_32 + _SCAN_64:
            if col.is_floating_point() or col.element_size() > 4:
                raise TypeError(f"{op} of {dt} has no scan lane")
            col = col.to(torch.int32)
        by_width[col.element_size()].append((t, col.contiguous(), op, dt))
    out: dict[str, torch.Tensor] = {}
    for chunked in by_width.values():
        for i in range(0, len(chunked), 4):
            chunk = chunked[i:i + 4]
            res = K.seg_scan_multi(flags, tuple(c[1] for c in chunk),
                                   tuple(c[2] for c in chunk))
            for (t, _col, _op, dt), o in zip(chunk, res):
                out[t] = o.to(dt)
    return out


def seg_cumsum(x: torch.Tensor, flags: torch.Tensor | None) -> torch.Tensor:
    x = x.contiguous()
    if x.dtype == torch.int64:
        return K.seg_cumsum_i64(flags, x)
    if x.dtype in (torch.int32, torch.float32, torch.float64):
        return K.seg_scan_multi(flags, (x,), ("add",))[0]
    raise TypeError(f"seg_cumsum of {x.dtype}: widen it first")


def seg_cummin(x: torch.Tensor, flags: torch.Tensor | None) -> torch.Tensor:
    return seg_extremes(flags, [("x", x, "min")])["x"]


def seg_cummax(x: torch.Tensor, flags: torch.Tensor | None) -> torch.Tensor:
    return seg_extremes(flags, [("x", x, "max")])["x"]


def _sum_and_squares(xf: torch.Tensor, flags: torch.Tensor | None):
    """Running sums of xf and xf² (float64), two lanes of one scan."""
    return K.seg_scan_multi(flags, (xf.contiguous(), (xf * xf).contiguous()),
                            ("add", "add"))


# --- running aggregates (reference sums/avgs/mins/maxs/vars/stddevs) ------

def sums(x, pos, flags):
    return seg_cumsum(x.to(_long_dtype(x.dtype)), flags)


def avgs(x, pos, flags):
    c = seg_cumsum(x.to(_long_dtype(x.dtype)), flags)
    return c / (pos + 1).to(_fp_dtype(x.dtype))


def mins(x, pos, flags):
    return seg_cummin(x, flags)


def maxs(x, pos, flags):
    return seg_cummax(x, flags)


def vars_(x, pos, flags):
    """Running population variance (the reference's Welford /(i+1))."""
    fp = _fp_dtype(x.dtype)
    s, ssq = _sum_and_squares(x.to(fp), flags)
    cnt = (pos + 1).to(fp)
    mean = s / cnt
    return torch.clamp(ssq / cnt - mean * mean, min=0)


def stddevs(x, pos, flags):
    return torch.sqrt(vars_(x, pos, flags))


def ratios(x, pos, flags):
    return ratiow(1, x, pos, flags)


def deltas(x, pos, flags):
    return torch.where(pos > 0, x - _shift_right(x, 1), torch.zeros_like(x))


def prev(x, pos, flags):
    return torch.where(pos > 0, _shift_right(x, 1), x)


def next_(x, pos, flags):
    """Reference ``aggnext``: shift left; each segment's last row keeps its
    own value."""
    if flags is None:
        flags = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    return torch.where(last_flags(flags), x, torch.roll(x, -1, 0))


# --- windowed aggregates (reference sumw/avgw/minw/maxw/varw/ratiow) ------

def sumw(w: int, x, pos, flags):
    """Trailing-w sum; partial windows at segment starts (the running
    sum)."""
    c = seg_cumsum(x.to(_long_dtype(x.dtype)), flags)
    return torch.where(pos >= w, c - _shift_right(c, w), c)


def avgw(w: int, x, pos, flags):
    s = sumw(w, x, pos, flags)
    return s / torch.clamp(pos + 1, max=w).to(_fp_dtype(x.dtype))


def _slide_extreme(w: int, x, pos, op):
    """Sliding min/max over the trailing w rows of each segment by
    sparse-table doubling: O(log w) masked shift-and-combine passes."""
    g = x
    covered = 1
    while covered < w:
        s = min(covered, w - covered)
        g = torch.where(pos >= s, op(g, _shift_right(g, s)), g)
        covered += s
    return g


def minw(w: int, x, pos, flags):
    return _slide_extreme(w, x, pos, torch.minimum)


def maxw(w: int, x, pos, flags):
    return _slide_extreme(w, x, pos, torch.maximum)


def varw(w: int, x, pos, flags):
    """Trailing-w population variance; the warm-up is the running variance
    (the reference's post-warm-up recurrence reads arr[-1],
    aggregations.h:311; this computes the exact window instead, as the JAX
    package does)."""
    fp = _fp_dtype(x.dtype)
    c, csq = _sum_and_squares(x.to(fp), flags)
    s = torch.where(pos >= w, c - _shift_right(c, w), c)
    ssq = torch.where(pos >= w, csq - _shift_right(csq, w), csq)
    cnt = torch.clamp(pos + 1, max=w).to(fp)
    mean = s / cnt
    return torch.clamp(ssq / cnt - mean * mean, min=0)


def stddevw(w: int, x, pos, flags):
    return torch.sqrt(varw(w, x, pos, flags))


def ratiow(w: int, x, pos, flags):
    """x[i] / x[i - w]; rows with pos < w divide by their segment's first
    row (reference ratiow, aggregations.h:169-188)."""
    xf = x.to(_fp_dtype(x.dtype))
    idx = torch.arange(x.shape[0], device=x.device)
    behind = torch.where(pos >= w, idx - w, idx - pos)
    return xf / xf[behind.clamp(0, x.shape[0] - 1)]


RUNNING = {
    "sums": sums, "avgs": avgs, "mins": mins, "maxs": maxs,
    "vars": vars_, "stddevs": stddevs, "ratios": ratios,
    "deltas": deltas, "prev": prev, "next": next_, "aggnext": next_,
}

WINDOWED = {
    "sums": sumw, "avgs": avgw, "mins": minw, "maxs": maxw,
    "vars": varw, "stddevs": stddevw, "ratios": ratiow,
    "sumw": sumw, "avgw": avgw, "minw": minw, "maxw": maxw,
    "varw": varw, "stddevw": stddevw, "ratiow": ratiow,
}


def result_type(name: str, t: T.SQLType) -> T.SQLType:
    """Static result type of a running/windowed op on element type t."""
    if name in ("sums", "sumw"):
        return T.long_type(t)
    if name in ("avgs", "avgw", "vars", "varw", "stddevs", "stddevw",
                "ratios", "ratiow"):
        return T.fp_type(T.long_type(t))
    return t
