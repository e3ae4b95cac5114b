"""Group reductions: dense slots, or runs of key-sorted rows.

Counterpart of ``segment_reduce`` and ``sorted_group_reduce`` in
``aquery2_tpu/ops/reduce.py``. The JAX package shaped both around the TPU
(bf16 digit matmuls on the MXU, int32 limb pairs, a v5e cost model for
extraction); the port keeps what they compute:

* ``segment_reduce`` (the dense tier): exact int64 sums and float64 sums
  through the onehot_segment_sums kernel (one call per 8 lanes, so the
  codes are read once for up to 8 of them), and ``scatter_reduce_``
  min/max from the same sentinels (the JAX package leaves those to XLA
  too). ``segment_reduce_keyed`` is the same sums in the kernel's keyed
  form: no codes, validity or products are made, the kernel reads the
  key and argument columns as they are stored.
* ``sorted_group_reduce`` (the packed tier): segmented scans over the
  sorted rows, whose value at each group's last row is the group's
  aggregate — sums through the seg_cumsum_i64 kernel in native int64,
  min/max of every dtype through seg_scan_multi (lanes of one word width
  share one call per 4, since they share the flags; bool, int8 and int16
  lanes widen to int32 there and come back), float64 sums by
  ``torch.cumsum`` — then one compaction of the group ends and one gather
  per lane.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops.scan import seg_extremes
from aquery2_tpu_torch.runtime.stats import sync


def big_of(dt: torch.dtype):
    """Identity of min for dt (+inf, True or the dtype's max)."""
    if dt.is_floating_point:
        return float("inf")
    if dt == torch.bool:
        return True
    return torch.iinfo(dt).max


def small_of(dt: torch.dtype):
    """Identity of max for dt (-inf, False or the dtype's min)."""
    if dt.is_floating_point:
        return float("-inf")
    if dt == torch.bool:
        return False
    return torch.iinfo(dt).min


def _sum_lane(col: torch.Tensor) -> torch.Tensor:
    """An add lane as onehot_segment_sums takes it: int64, int32 or bool
    as they are, other integer dtypes widened to int64."""
    if col.dtype not in K.ONEHOT_DTYPES:
        col = col.to(torch.int64)
    return col.contiguous()


def segment_reduce(code: torch.Tensor, add_lanes: dict[str, torch.Tensor],
                   min_lanes: dict[str, torch.Tensor],
                   max_lanes: dict[str, torch.Tensor],
                   f64_lanes: dict[str, torch.Tensor],
                   domain: int) -> dict[str, torch.Tensor]:
    """Reduce rows into ``domain + 1`` dense slots. ``code`` is each row's
    slot (contiguous int32; invalid rows carry ``domain``, the overflow
    slot). Add lanes are integer or bool tensors, summed exactly in int64;
    min/max lanes are pre-masked with the sentinels; f64 lanes are
    float64 sums, in the same kernel calls as the add lanes. Returns tag →
    [domain + 1] tensors."""
    dp = domain + 1
    dev = code.device
    outs: dict[str, torch.Tensor] = {}
    lanes = ({t: _sum_lane(c) for t, c in add_lanes.items()}
             | {t: c.to(torch.float64).contiguous()
                for t, c in f64_lanes.items()})
    tags = list(lanes)
    for i in range(0, len(tags), K.ONEHOT_MAX_LANES):
        chunk = tags[i:i + K.ONEHOT_MAX_LANES]
        sums = K.onehot_segment_sums(code, tuple(lanes[t] for t in chunk), dp)
        for j, t in enumerate(chunk):
            outs[t] = (sums[:, j].view(torch.float64) if t in f64_lanes
                       else sums[:, j])
    if min_lanes or max_lanes:
        idx = code.to(torch.int64)       # scatter_reduce_ takes int64 only
    for t, col in min_lanes.items():
        outs[t] = torch.full((dp,), big_of(col.dtype), dtype=col.dtype,
                             device=dev).scatter_reduce_(0, idx, col, "amin")
    for t, col in max_lanes.items():
        outs[t] = torch.full((dp,), small_of(col.dtype), dtype=col.dtype,
                             device=dev).scatter_reduce_(0, idx, col, "amax")
    return outs


def segment_reduce_keyed(keys: list[torch.Tensor], mins: list[int],
                         strides: list[int], row_mask: torch.Tensor | None,
                         n: int, add_lanes: dict, f64_lanes: dict,
                         domain: int) -> dict[str, torch.Tensor]:
    """Reduce rows [0, n) into ``domain`` dense slots with onehot_segment_sums'
    keyed form: a row's slot is the sum of (key - min) * stride over the
    key columns as stored, and a row whose ``row_mask`` is False is
    dropped. An add lane is an integer or bool tensor (summed exactly in
    int64), a pair (a, b) of them (the sum of a * b in int64) or None
    (the slot's row count); f64 lanes are float64 sums. Columns of at
    least n rows; one call per 8 columns, an aggregate's product beside
    its sources where they fit. Returns tag → [domain] tensors."""
    widened: dict[int, tuple] = {}

    def lane(x: torch.Tensor) -> torch.Tensor:
        """x as the kernel takes it, once per tensor, cut to n rows."""
        if id(x) not in widened:
            w = (x.to(torch.float64) if x.is_floating_point()
                 else _sum_lane(x))[:n]
            widened[id(x)] = (x, w)       # x kept, so that its id stays
        return widened[id(x)][1]

    calls: list[dict] = []
    for t, c in ({**add_lanes, **f64_lanes}).items():
        srcs = [] if c is None else [lane(x) for x in
                                     (c if isinstance(c, tuple) else (c,))]
        call = calls[-1] if calls else None
        if call is not None:
            new = {id(x) for x in srcs} - {id(x) for x in call["src"]}
            width = (len(call["src"]) + len(call["prod"]) + call["count"]
                     + len(new) + (isinstance(c, tuple)
                                   or (c is None and not call["count"])))
            if width > K.ONEHOT_MAX_LANES:
                call = None
        if call is None:
            call = {"src": [], "prod": [], "count": False, "tags": {}}
            calls.append(call)
        ids = [id(x) for x in call["src"]]
        for x in srcs:
            if id(x) not in ids:
                call["src"].append(x)
                ids.append(id(x))
        if c is None:
            call["count"] = True
            call["tags"][t] = "count"
        elif isinstance(c, tuple):
            call["prod"].append(tuple(ids.index(id(x)) for x in srcs))
            call["tags"][t] = ("prod", len(call["prod"]) - 1)
        else:
            call["tags"][t] = ids.index(id(srcs[0]))
    key_cols = [x.contiguous()[:n] for x in keys]
    mask = None if row_mask is None else row_mask.contiguous()[:n]
    outs: dict[str, torch.Tensor] = {}
    for call in calls:
        nsrc, nprod = len(call["src"]), len(call["prod"])
        sums = K.onehot_segment_sums(
            key_cols[0], tuple(call["src"]), domain, keys=tuple(key_cols[1:]),
            mins=tuple(mins), strides=tuple(strides), row_mask=mask,
            products=tuple(call["prod"]), counts=call["count"])
        for t, j in call["tags"].items():
            j = (nsrc + nprod if j == "count"
                 else nsrc + j[1] if isinstance(j, tuple) else j)
            outs[t] = (sums[:, j].view(torch.float64) if t in f64_lanes
                       else sums[:, j])
    return outs


def sorted_group_reduce(starts: torch.Tensor, last: torch.Tensor,
                        add_lanes: dict[str, torch.Tensor],
                        min_lanes: dict[str, torch.Tensor],
                        max_lanes: dict[str, torch.Tensor],
                        f64_lanes: dict[str, torch.Tensor],
                        extract: dict[str, torch.Tensor] | None = None,
                        counts_from_ends: str | None = None):
    """Group reduction over rows already sorted by group key.

    starts: [n] bool, True at each group's first row. last: [n] bool, True
    at each VALID group's last row. Add lanes are integer or bool tensors,
    summed in int64; min/max lanes of any integer, bool or float dtype,
    pre-masked with the sentinels, come back in their dtype; f64 lanes
    float64 sums. extract: [n] tensors wanted at each group's last row
    (the sort keys).

    counts_from_ends: a tag under which to return the int64 group sizes
    as differences of the end-row indices, in place of that add lane
    (which is not scanned). Only right when invalid rows sort behind every
    valid group, so that every row before the last end is valid.

    Returns (outs, ends_idx): tag → [g] per group in key order, and the
    [g] end-row indices. The compaction of ``last`` is the one host sync
    here (it fixes g; ``groupby.group_ends`` in the session's
    ``syncs_by_site``)."""
    scanned: dict[str, torch.Tensor] = {}
    for t, col in add_lanes.items():
        if t != counts_from_ends:
            scanned[t] = K.seg_cumsum_i64(starts, col.to(torch.int64))
    scanned.update(seg_extremes(
        starts, [(t, col, "min") for t, col in min_lanes.items()]
        + [(t, col, "max") for t, col in max_lanes.items()]))
    running = {t: torch.cumsum(col.to(torch.float64), 0)
               for t, col in f64_lanes.items()}
    scanned.update(extract or {})

    with sync("groupby.group_ends"):
        ends_idx = torch.nonzero(last).squeeze(1)
    outs = {t: v[ends_idx] for t, v in scanned.items()}
    for t, v in running.items():         # running sum → boundary difference
        ends_v = v[ends_idx]
        outs[t] = ends_v - torch.cat([ends_v.new_zeros(1), ends_v[:-1]])
    if counts_from_ends is not None:
        prev = torch.cat([ends_idx.new_full((1,), -1), ends_idx])[:-1]
        outs[counts_from_ends] = ends_idx - prev
    return outs, ends_idx
