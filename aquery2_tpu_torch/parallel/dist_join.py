"""Distributed equi-join: hash exchange, then the local probe.

Counterpart of ``aquery2_tpu/parallel/dist_join.py``. Rows move so that
equal keys meet on one rank, destination = hash(key) mod world (the key
hash of engine/join.py), in one split-size exchange per side
(comm.all_to_all_v); then each rank probes its received rows with the
single-device join (engine/join.py). The JAX package packs fixed
[world, cap] buckets for XLA's static shapes and retries with doubled
caps when a skewed key overflows one; here the exchange is sized by a
first trade of per-destination counts, so nothing overflows or retries.
Only valid rows are sent.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.engine import join as J
from aquery2_tpu_torch.parallel import comm

_HASH_MASK = (1 << 62) - 1


def destinations(mesh, keys: list[torch.Tensor]) -> torch.Tensor:
    """int64 rank of each row: the hash of its key tuple mod world."""
    return (J._key_hash(keys) & _HASH_MASK) % mesh.world


def exchange(mesh, keys: list[torch.Tensor], payloads: list[torch.Tensor],
             valid: torch.Tensor) -> tuple[list, list]:
    """The valid rows of (keys, payloads), moved to the ranks their keys
    hash to: (received keys, received payloads), rank 0's rows first."""
    idx = torch.nonzero(valid).squeeze(1)
    ks = [k[idx] for k in keys]
    ps = [p[idx] for p in payloads]
    got = comm.all_to_all_v(mesh, destinations(mesh, ks), ks + ps)
    return got[:len(ks)], got[len(ks):]


def dist_join_counts(mesh, lkey, lvalid, rkey, rvalid) -> int:
    """The global count of (left, right) pairs with equal keys: both
    sides exchanged, each rank counts its pairs by sort and searchsorted,
    one all_reduce sums them."""
    (lk,), _ = exchange(mesh, [lkey], [], lvalid)
    (rk,), _ = exchange(mesh, [rkey], [], rvalid)
    dt = torch.promote_types(lk.dtype, rk.dtype)
    keys = torch.sort(rk.to(dt)).values
    q = lk.to(dt)
    cnt = (torch.searchsorted(keys, q, side="right")
           - torch.searchsorted(keys, q, side="left"))
    if q.is_floating_point():
        cnt = torch.where(q.isnan(), 0, cnt)
    total = cnt.sum(dtype=torch.int64).reshape(1)
    return int(comm.all_reduce(mesh, total, "sum")[0])


def dist_equijoin_outer(mesh, lkey, lvalid, lpays, rkey, rvalid, rpays,
                        emit_left: bool, emit_right: bool):
    """This rank's rows of the equi-join (inner where neither flag is
    set), with the unmatched left rows (emit_left: LEFT, FULL) and the
    unmatched right rows (emit_right: FULL): (key, left payloads, right
    payloads, lnull, rnull), lnull and rnull marking the rows whose left
    or right side is missing. After the exchange a key absent here is
    absent everywhere, so each rank's unmatched rows are the join's."""
    (lk,), lp = exchange(mesh, [lkey], lpays, lvalid)
    (rk,), rp = exchange(mesh, [rkey], rpays, rvalid)
    dt = torch.promote_types(lk.dtype, rk.dtype)
    kind = ("full" if emit_right else "left") if emit_left else \
        ("right" if emit_right else None)
    ln, rn = int(lk.shape[0]), int(rk.shape[0])
    if ln == 0 or rn == 0:              # no pair here: only unmatched rows
        dev = lk.device
        keep_l = emit_left and ln > 0
        keep_r = emit_right and rn > 0
        li = torch.cat([torch.arange(ln if keep_l else 0, device=dev),
                        torch.full((rn if keep_r else 0,), -1, device=dev)])
        ri = torch.cat([torch.full((ln if keep_l else 0,), -1, device=dev),
                        torch.arange(rn if keep_r else 0, device=dev)])
    elif kind is None:
        li, ri, m = J.equi_join([lk.to(dt)], [rk.to(dt)], ln, rn)
        li, ri = li[:m], ri[:m]
    else:
        li, ri, m = J.outer_join([lk.to(dt)], [rk.to(dt)], ln, rn, kind)
        li, ri = li[:m], ri[:m]
    lnull, rnull = li < 0, ri < 0
    ls, rs = li.clamp(min=0), ri.clamp(min=0)

    def take(x, i, null):
        if x.shape[0] == 0:                 # this rank received no rows
            return torch.zeros(i.shape[0], dtype=x.dtype, device=x.device)
        v = x[i]
        return torch.where(null, torch.zeros((), dtype=v.dtype,
                                             device=v.device), v)

    key = torch.where(lnull, take(rk, rs, rnull).to(dt),
                      take(lk, ls, lnull).to(dt))
    return (key, [take(p, ls, lnull) for p in lp],
            [take(p, rs, rnull) for p in rp], lnull, rnull)
