"""Per-group aggregates over the group-sorted row layout.

Counterpart of ``aquery2_tpu/engine/grouped_agg.py``. There each aggregate
is one or two XLA segment reductions. Here the rows are already sorted by
group (engine/groupby.py), so a group's sum, min or max is the value at
its last row of a segmented running scan (ops/scan: int64 sums through
the seg_cumsum_i64 kernel, every other sum and min/max through
seg_scan_multi), read with one gather; the padding rows make a segment
of their own after the last group. An ungrouped query is one group: it
takes ops/agg's full reductions. (A scatter of sorted rows into their
slots, ``index_add_``, serialises on the card's atomics: 31 ms for one
float64 sum of q6 on G1_1e7_1e1_5_0 on an NVIDIA H100 80GB HBM3 at
700 W, PERF.md §6.)

Arguments come in as row Values whose ``mask`` (subvec, or NULL rows
folded in by the evaluator) selects the rows an aggregate reads; masked
rows get the reduction's identity. Two rules differ from the JAX package,
which is wrong there (ROADMAP queue 3): median skips masked (NULL) rows,
where the JAX package sorts them in as zeros; corr reads the rows where
both arguments are non-NULL, where the JAX package counts x's alone.
first and last read the group's first and last row and keep its NULL.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.ops import agg
from aquery2_tpu_torch.ops import scan as S
from aquery2_tpu_torch.ops.reduce import big_of, small_of
from aquery2_tpu_torch.ops.scan import _fp_dtype, _long_dtype
from aquery2_tpu_torch.ops.sort import lexsort

_FULL = {"sum": agg.sum_, "min": agg.min_, "max": agg.max_}


def _seg_reduce(ctx, kind: str, x: torch.Tensor) -> torch.Tensor:
    """[gcap] per-group sum/min/max of x (masked rows already set to the
    identity)."""
    if ctx.grouping is None:
        return _FULL[kind](x, ctx.ws.n).reshape(1)
    if kind == "sum":
        run = S.seg_cumsum(x, ctx.flags)
    else:
        run = S.seg_extremes(ctx.flags, [("x", x, kind)])["x"]
    return run[(ctx.group_ends - 1).clamp(min=0)]


def _masked(x: torch.Tensor, mask, ident) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask, x, torch.full((), ident, dtype=x.dtype,
                                           device=x.device))


def _count(ctx, mask) -> torch.Tensor:
    if mask is None:
        return ctx.group_lens
    return _seg_reduce(ctx, "sum", mask.to(torch.int64))


def _median(ctx, x: torch.Tensor, mask) -> torch.Tensor:
    """Each group's median: one sort by (group, masked out, value), the
    middle rows of each group's unmasked run."""
    fp = _fp_dtype(x.dtype)
    if ctx.grouping is None and mask is None:
        return agg.median(x, ctx.ws.n).reshape(1)
    # padding rows carry the group id past every group's: they sort last
    keys = [(ctx.seg, True, (0, ctx.G))]
    if mask is not None:
        keys.append((~mask, True))
    xs = lexsort(keys + [(x, True)])[1][-1]
    cnt = _count(ctx, mask)
    starts = ctx.group_starts
    lo = starts + torch.clamp((cnt - 1) // 2, min=0)
    hi = starts + torch.clamp(cnt // 2, min=0)
    last = xs.shape[0] - 1
    return (xs[lo.clamp(0, last)].to(fp) + xs[hi.clamp(0, last)].to(fp)) * 0.5


def compute(ctx, name: str, args: list):
    """ctx: engine.eval.EvalContext; args: row-kind Values. Returns a
    group-kind Value of [gcap] rows."""
    from aquery2_tpu_torch.engine.eval import Value

    v = args[0]
    x, mask, t = v.data, v.mask, v.sqltype

    if name == "count":
        return Value("group", _count(ctx, mask), T.LongT)

    if name == "sum":
        xs = _masked(x, mask, 0).to(_long_dtype(x.dtype))
        return Value("group", _seg_reduce(ctx, "sum", xs), T.long_type(t))

    if name in ("avg", "mean"):
        xs = _masked(x, mask, 0).to(_long_dtype(x.dtype))
        fp = _fp_dtype(x.dtype)
        s = _seg_reduce(ctx, "sum", xs).to(fp)
        return Value("group", s / torch.clamp(_count(ctx, mask), min=1).to(fp),
                     T.fp_type(T.long_type(t)))

    if name in ("min", "max"):
        ident = big_of(x.dtype) if name == "min" else small_of(x.dtype)
        return Value("group", _seg_reduce(ctx, name, _masked(x, mask, ident)),
                     t, v.dictionary)

    if name in ("first", "last"):
        idx = ctx.group_starts if name == "first" else ctx.group_ends - 1
        idx = idx.clamp(0, x.shape[0] - 1)
        return Value("group", x[idx], t, v.dictionary,
                     nulls=None if v.nulls is None else v.nulls[idx])

    if name in ("var", "stddev"):
        fp = torch.float64
        xs = _masked(x, mask, 0).to(_long_dtype(x.dtype))
        s = _seg_reduce(ctx, "sum", xs).to(fp)
        ssq = _seg_reduce(ctx, "sum", xs * xs).to(fp)
        cnt = _count(ctx, mask).to(fp)
        denom = torch.clamp(
            cnt + (1.0 if config.STRICT_REFERENCE_SEMANTICS else 0.0), min=1.0)
        out = (ssq - s * s / denom) / denom
        if name == "stddev":
            out = torch.sqrt(torch.clamp(out, min=0))
        return Value("group", out, T.DoubleT)

    if name == "corr":
        y = args[1]
        both = mask if y.mask is None else (
            y.mask if mask is None else mask & y.mask)
        fp = torch.float64
        xs = _masked(x, both, 0).to(_long_dtype(x.dtype))
        ys = _masked(y.data, both, 0).to(_long_dtype(y.data.dtype))
        sx = _seg_reduce(ctx, "sum", xs).to(fp)
        sy = _seg_reduce(ctx, "sum", ys).to(fp)
        sxy = _seg_reduce(ctx, "sum", (xs * ys).to(fp))
        sx2 = _seg_reduce(ctx, "sum", (xs * xs).to(fp))
        sy2 = _seg_reduce(ctx, "sum", (ys * ys).to(fp))
        nn = _count(ctx, both).to(fp)
        num = nn * sxy - sx * sy
        return Value("group", num / torch.sqrt((nn * sx2 - sx * sx)
                                               * (nn * sy2 - sy * sy)),
                     T.DoubleT)

    if name == "median":
        return Value("group", _median(ctx, x, mask), T.fp_type(t))

    raise ValueError(f"unknown aggregate {name}")
