"""Grouping strategies of the general engine.

Counterpart of ``aquery2_tpu/engine/groupby.py``; the strategy is chosen
from per-key min/max stats, as there:

* **dense** (perfect hash): integer keys whose packed domain
  Π(max - min + 1) is at most config.PERFECT_HASH_MAX_DOMAIN are
  direct-addressed (ops/hashing.dense_pack): a histogram of the codes
  and a prefix sum rank them, no sort.
* **sort**: other keys (floats, wide or many keys) take
  fused_groupby.sorted_groups, one stable ops/sort.lexsort of [validity,
  keys...]; a group starts where a key changes (NaN keys make one group,
  last).

Both give a ``Grouping``: each row's group id, groups in ascending key
order, and the group-sorted layout the evaluator reads (the permutation
that clusters rows by group, keeping their order within a group, each
row's position in its group, segment start flags, and the group offsets).
Everything stays on the device; the group count is the one host sync of
each strategy (and the keys' stats, one sync each, for the dense test).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from aquery2_tpu_torch import config
from aquery2_tpu_torch.ops import hashing
from aquery2_tpu_torch.ops.segment import flags_from_segment_ids


@dataclass
class Grouping:
    """Rows grouped by a key tuple."""
    num_groups: int                    # G, on the host
    seg_ids: torch.Tensor              # [cap] int64; padding rows → G
    key_values: list[torch.Tensor]     # per key, [gcap] in group order
    n: int                             # logical row count
    capacity: int
    # [G + 2] int64: group g spans rows [offsets[g], offsets[g + 1]) of
    # the sorted layout, the padding rows [offsets[G], offsets[G + 1])
    offsets: torch.Tensor
    _order: torch.Tensor | None = None
    _sorted_seg: torch.Tensor | None = None
    _pos: torch.Tensor | None = None
    _flags: torch.Tensor | None = None

    @property
    def order(self) -> torch.Tensor:
        """The permutation that clusters rows by group (stable): one radix
        sort of the group ids in the narrowest integer type that holds
        them (the padding rows' G sorts last)."""
        if self._order is None:
            dt = torch.int16 if self.num_groups < 1 << 15 else torch.int32
            self._order = torch.sort(self.seg_ids.to(dt), stable=True)[1]
        return self._order

    @property
    def sorted_seg(self) -> torch.Tensor:
        if self._sorted_seg is None:
            self._sorted_seg = self.seg_ids[self.order]
        return self._sorted_seg

    @property
    def flags(self) -> torch.Tensor:
        if self._flags is None:
            self._flags = flags_from_segment_ids(self.sorted_seg)
        return self._flags

    @property
    def pos(self) -> torch.Tensor:
        """Each sorted row's int32 position within its group."""
        if self._pos is None:
            idx = torch.arange(self.capacity, device=self.seg_ids.device)
            self._pos = (idx - self.offsets[self.sorted_seg]).to(torch.int32)
        return self._pos


def _padded(x: torch.Tensor, g: int) -> torch.Tensor:
    """x[:g] zero-padded to bucket_size(g) rows."""
    x = x[:g]
    return torch.cat([x, x.new_zeros(config.bucket_size(max(g, 1)) - g)])


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """[k + 1] int64 exclusive prefix sums of k counts."""
    return F.pad(torch.cumsum(counts, 0), (1, 0))


def _dense(codes: torch.Tensor, domain: int, n: int):
    """Direct-addressed grouping: a histogram of the codes (the padding
    rows in slot ``domain``), whose non-empty slots rank by a prefix sum.
    (seg ids, G, the present codes ascending, offsets)."""
    dev = codes.device
    valid = torch.arange(codes.shape[0], device=dev) < n
    safe = torch.where(valid, codes, domain)
    counts = torch.bincount(safe, minlength=domain + 1)
    presence = counts[:domain] > 0
    rank = torch.cumsum(presence, 0, dtype=torch.int32) - 1
    ucodes = torch.nonzero(presence).squeeze(1)
    g = int(ucodes.shape[0])
    seg = torch.where(valid, rank[safe.clamp(max=domain - 1)].to(torch.int64),
                      g)
    return seg, g, ucodes, _offsets(torch.cat([counts[ucodes],
                                               counts[domain:]]))


def _sort(arrays: list[torch.Tensor], n: int):
    """Sort grouping: (seg ids, G, representative keys, the sort
    permutation, which clusters rows by group and keeps row order within
    a group, as a stable sort by group id would)."""
    from aquery2_tpu_torch.engine.fused_groupby import sorted_groups

    valid = torch.arange(arrays[0].shape[0], device=arrays[0].device) < n
    perm, valid_s, sk, starts, _last = sorted_groups(
        valid, [(a, True) for a in arrays])
    firsts = starts & valid_s
    start_idx = torch.nonzero(firsts).squeeze(1)
    g = int(start_idx.shape[0])
    gid = torch.cumsum(firsts, 0) - 1
    gid = torch.where(valid_s, gid, g)
    seg = torch.empty_like(gid).scatter_(0, perm, gid)
    ends = torch.tensor([n, perm.shape[0]], device=perm.device)
    return seg, g, [s[start_idx] for s in sk], perm, \
        torch.cat([start_idx, ends])


def group_by(key_cols: list, n: int) -> Grouping:
    """Group rows by key columns: objects with ``.data`` (a [cap] tensor)
    and ``.stats()`` ((min, max) of the first n rows)."""
    arrays = [c.data for c in key_cols]
    capacity = int(arrays[0].shape[0])
    dense_ok = n > 0
    stats, domain = [], 1
    for c in key_cols:
        if c.data.is_floating_point():
            dense_ok = False
            break
        mn, mx = c.stats()
        stats.append((int(mn), int(mx)))
        domain *= stats[-1][1] - stats[-1][0] + 1
        if domain > config.PERFECT_HASH_MAX_DOMAIN:
            dense_ok = False
            break
    if dense_ok:
        codes, domain, strides = hashing.dense_pack(
            [(a, mn, mx) for a, (mn, mx) in zip(arrays, stats)])
        seg, g, ucodes, offsets = _dense(codes, domain, n)
        keys = hashing.dense_unpack(ucodes, stats, strides)
        return Grouping(g, seg, [_padded(k.to(a.dtype), g)
                                 for k, a in zip(keys, arrays)],
                        n, capacity, offsets)
    seg, g, reps, perm, offsets = _sort(arrays, n)
    return Grouping(g, seg, [_padded(r, g) for r in reps], n, capacity,
                    offsets, _order=perm)
