"""Whole-column aggregates: masked reductions.

Counterpart of ``aquery2_tpu/ops/agg.py`` (the reference's scalar
aggregate loops, server/aggregations.h). Each takes (x, n): a padded
tensor and the logical row count; rows at or past n are masked with the
reduction's identity. The JAX package's dtype rules: sums accumulate in
int64 (integers, bools) or float64, averages and variances are float64,
min/max keep x's dtype. As there, var divides by n + 1 under
config.STRICT_REFERENCE_SEMANTICS.

engine/grouped_agg.py reduces an ungrouped query's single group with
these (a full reduction, where a scatter into one slot would serialise
on the card's atomics).
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch.ops.reduce import big_of, small_of
from aquery2_tpu_torch.ops.scan import _fp_dtype, _long_dtype
from aquery2_tpu_torch.ops.sort import sort_perm


def _mask(x: torch.Tensor, n, ident) -> torch.Tensor:
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(idx < n, x, torch.full((), ident, dtype=x.dtype,
                                              device=x.device))


def sum_(x: torch.Tensor, n) -> torch.Tensor:
    return _mask(x, n, 0).to(_long_dtype(x.dtype)).sum()


def avg(x: torch.Tensor, n) -> torch.Tensor:
    return sum_(x, n).to(_fp_dtype(x.dtype)) / n


def min_(x: torch.Tensor, n) -> torch.Tensor:
    return _mask(x, n, big_of(x.dtype)).min()


def max_(x: torch.Tensor, n) -> torch.Tensor:
    return _mask(x, n, small_of(x.dtype)).max()


def count(x: torch.Tensor, n) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int64, device=x.device)


def first(x: torch.Tensor, n) -> torch.Tensor:
    return x[0]


def last(x: torch.Tensor, n) -> torch.Tensor:
    return x[max(int(n) - 1, 0)]


def var(x: torch.Tensor, n) -> torch.Tensor:
    fp = _fp_dtype(x.dtype)
    xl = _mask(x, n, 0).to(_long_dtype(x.dtype))
    s = xl.sum().to(fp)
    ssq = (xl * xl).sum().to(fp)
    denom = n + (1 if config.STRICT_REFERENCE_SEMANTICS else 0)
    return (ssq - s * s / denom) / denom


def stddev(x: torch.Tensor, n) -> torch.Tensor:
    return torch.sqrt(var(x, n))


def corr(x: torch.Tensor, y: torch.Tensor, n) -> torch.Tensor:
    """Pearson correlation from raw moments; integer inputs sum exactly
    in int64 before the float64 formula."""
    fp = torch.float64
    xl = _mask(x, n, 0).to(_long_dtype(x.dtype))
    yl = _mask(y, n, 0).to(_long_dtype(y.dtype))
    sx, sy = xl.sum().to(fp), yl.sum().to(fp)
    sxy = (xl * yl).to(fp).sum()
    sx2 = (xl * xl).to(fp).sum()
    sy2 = (yl * yl).to(fp).sum()
    num = n * sxy - sx * sy
    return num / torch.sqrt((n * sx2 - sx * sx) * (n * sy2 - sy * sy))


def median(x: torch.Tensor, n) -> torch.Tensor:
    """The median by one device sort; an even n averages the two middle
    values. n may be a tensor (a count that stays on the device)."""
    fp = _fp_dtype(x.dtype)
    s = x[sort_perm([(x, True)], n)]
    n = torch.as_tensor(n, device=x.device)
    lo = s[torch.clamp((n - 1) // 2, min=0)].to(fp)
    hi = s[torch.clamp(n // 2, min=0)].to(fp)
    return (lo + hi) * 0.5


# name → (fn, arity)
SCALAR_AGGS = {
    "sum": (sum_, 1), "avg": (avg, 1), "mean": (avg, 1), "min": (min_, 1),
    "max": (max_, 1), "count": (count, 1), "first": (first, 1),
    "last": (last, 1), "var": (var, 1), "stddev": (stddev, 1),
    "corr": (corr, 2), "median": (median, 1),
}
