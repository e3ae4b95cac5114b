"""Distributed group-by primitives: dense partials, or a row shuffle.

Counterpart of ``aquery2_tpu/parallel/dist_groupby.py``:

  dist_grouped_sums          each rank sums its rows into [domain] slots
                             (ops/reduce.segment_reduce, the
                             onehot_segment_sums kernel), and one
                             all_reduce per dtype adds the ranks' slots:
                             traffic O(domain), none of it rows;
  dist_grouped_sums_shuffle  rows move to hash(code) mod world
                             (dist_join.exchange), then each rank reduces
                             its groups over sorted rows
                             (ops/reduce.sorted_group_reduce, the
                             seg_cumsum_i64 kernel); every group lives on
                             one rank.

The JAX package's fixed shuffle buckets, their overflow counts and the
``_safe`` retries have no counterpart: the exchange is sized exactly.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.engine.fused_groupby import sorted_groups
from aquery2_tpu_torch.ops import reduce as R
from aquery2_tpu_torch.parallel import comm
from aquery2_tpu_torch.parallel.dist_join import exchange


def dist_grouped_sums(mesh, codes: torch.Tensor, vals: list[torch.Tensor],
                      valid: torch.Tensor, domain: int):
    """(counts [domain], sums [domain] per lane), whole on every rank.
    codes: this rank's rows' slots in [0, domain); vals: integer lanes;
    valid: the rows that count. domain ≤ 512 (the kernel's slots)."""
    code = torch.where(valid, codes, domain).to(torch.int32).contiguous()
    add = {"__counts__": valid, **{f"s{i}": v for i, v in enumerate(vals)}}
    outs = R.segment_reduce(code, add, {}, {}, {}, domain)
    red = comm.all_reduce_lanes(mesh, {t: o[:domain].to(torch.int64)
                                       for t, o in outs.items()}, "sum")
    return (red["__counts__"], *[red[f"s{i}"] for i in range(len(vals))])


def dist_grouped_sums_shuffle(mesh, codes: torch.Tensor,
                              vals: list[torch.Tensor], valid: torch.Tensor):
    """This rank's groups after the shuffle: (codes [g], counts [g], sums
    [g] per lane), code-ascending; each code's group is on exactly one
    rank."""
    (c,), vs = exchange(mesh, [codes], vals, valid)
    ok = torch.ones(c.shape, dtype=torch.bool, device=c.device)
    perm, valid_s, sk, starts, last = sorted_groups(ok, [(c, True)])
    add = {f"s{i}": v[perm] for i, v in enumerate(vs)}
    add["__counts__"] = valid_s
    outs, _ends = R.sorted_group_reduce(starts, last, add, {}, {}, {},
                                        extract={"__code": sk[0]},
                                        counts_from_ends="__counts__")
    return (outs["__code"], outs["__counts__"],
            *[outs[f"s{i}"] for i in range(len(vals))])
