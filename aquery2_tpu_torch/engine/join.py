"""The general equi-join on the device: inner and outer.

Counterpart of ``aquery2_tpu/engine/join.py``. Each side's key tuple
hashes to 64 bits (ops/hashing: ``hash64`` per column, ``combine_hashes``
across them); the build (right) side sorts by hash and every probe (left)
row finds its run of equal hashes with two ``torch.searchsorted`` calls,
the JAX package's XLA ``searchsorted``. ``ops/ragged.expand`` enumerates
the candidate pairs, a comparison of the real keys drops hash collisions,
and one compaction keeps the verified pairs. Pairs come out by left row,
then right row (the sort is stable), as in the JAX package.

A NULL key and a padding row match nothing: a left one probes with no
candidates, and a right one sorts last and fails the verification. An
outer join adds the unmatched rows, marked -1 on their missing side: the
left ones after the pairs, then the right ones. Its matched masks are
scatters of the verified indices and its unmatched rows compactions, all
on the device (the JAX package builds them with numpy on the host).

Host syncs: the candidate total (it fixes the expansion's capacity), the
verified count, and for an outer join the count of each side's unmatched
rows, counted in the session's ``syncs_by_site`` as ``join.candidates``,
``join.verified``, ``join.unmatched_left`` and ``join.unmatched_right``.
Its parts run in the spans ``aq.join.hash``, ``.sort``, ``.probe``,
``.expand``, ``.verify`` and ``.outer`` (runtime/stats.py).
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch.ops import hashing, ragged
from aquery2_tpu_torch.ops.filter import compact_indices
from aquery2_tpu_torch.ops.sort import canonical_float
from aquery2_tpu_torch.runtime.stats import span, sync


def _key_hash(cols: list[torch.Tensor]) -> torch.Tensor:
    """int64 hash of each row's key tuple (floats by the bits of their
    canonical float64 value, so -0.0 hashes as 0.0)."""
    hs = [hashing.hash64(hashing.bits64(canonical_float(c).to(torch.float64))
                         if c.is_floating_point() else c.to(torch.int64))
          for c in cols]
    return hs[0] if len(hs) == 1 else hashing.combine_hashes(hs)


def _rows_ok(cap: int, n: int, nulls, device) -> torch.Tensor:
    ok = torch.arange(cap, device=device) < n
    return ok if nulls is None else ok & ~nulls[:cap]


def _padded(x: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(cap - x.shape[0])])


def equi_join(lkeys: list[torch.Tensor], rkeys: list[torch.Tensor],
              ln: int, rn: int, lnulls: torch.Tensor | None = None,
              rnulls: torch.Tensor | None = None):
    """Inner equi-join: (li, ri, m), the left and right row indices of the
    m result pairs, int64, padded with zeros to bucket_size(m).

    Key columns come in pairs of one dtype (the caller promotes them and
    puts string codes into one dictionary); lnulls/rnulls mark NULL keys,
    which never match."""
    dev = lkeys[0].device
    with span("join.hash"):
        lok = _rows_ok(lkeys[0].shape[0], ln, lnulls, dev)
        rok = _rows_ok(rkeys[0].shape[0], rn, rnulls, dev)
        lh = _key_hash(lkeys)
        # NULL and padding build rows sort last and fail the verification;
        # a probe hash equal to theirs (odds 2^-64 a row) only adds
        # candidates
        rh = torch.where(rok, _key_hash(rkeys), torch.iinfo(torch.int64).max)
    with span("join.sort"):
        rh_sorted, perm_r = torch.sort(rh, stable=True)
    with span("join.probe"):
        lo = torch.searchsorted(rh_sorted, lh, side="left")
        hi = torch.searchsorted(rh_sorted, lh, side="right")
    with span("join.expand"):
        counts = torch.where(lok, hi - lo, 0)
        with sync("join.candidates"):
            total = int(counts.sum())
        li, within, valid = ragged.expand(counts,
                                          config.bucket_size(max(total, 1)),
                                          total)
        ri = perm_r[(lo[li] + within).clamp(0, perm_r.shape[0] - 1)]
    with span("join.verify"):
        ok = valid & rok[ri]
        for lk, rk in zip(lkeys, rkeys):                # drop collisions
            ok &= lk[li] == rk[ri]
        with sync("join.verified"):
            keep, m = compact_indices(ok)
        cap = config.bucket_size(max(m, 1))
        return _padded(li[keep], cap), _padded(ri[keep], cap), m


def outer_join(lkeys: list[torch.Tensor], rkeys: list[torch.Tensor],
               ln: int, rn: int, kind: str,
               lnulls: torch.Tensor | None = None,
               rnulls: torch.Tensor | None = None):
    """LEFT, RIGHT or FULL outer equi-join: (li, ri, m) as equi_join's,
    with -1 on the missing side of each unmatched row: the pairs, then
    the unmatched left rows (left, full), then the unmatched right rows
    (right, full), each in row order."""
    li, ri, m = equi_join(lkeys, rkeys, ln, rn, lnulls, rnulls)
    with span("join.outer"):
        parts_l, parts_r = [li[:m]], [ri[:m]]
        for side, idx, n, want in ((0, li, ln, ("left", "full")),
                                   (1, ri, rn, ("right", "full"))):
            if kind not in want:
                continue
            matched = torch.zeros(n, dtype=torch.bool, device=idx.device)
            matched.index_fill_(0, idx[:m], True)
            with sync("join.unmatched_right" if side
                      else "join.unmatched_left"):
                rows, k = compact_indices(~matched)
            miss = torch.full((k,), -1, dtype=torch.int64, device=idx.device)
            parts_l.append(miss if side else rows)
            parts_r.append(rows if side else miss)
        lo_all, ro_all = torch.cat(parts_l), torch.cat(parts_r)
        total = int(lo_all.shape[0])
        cap = config.bucket_size(max(total, 1))
        return _padded(lo_all, cap), _padded(ro_all, cap), total
