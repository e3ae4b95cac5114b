"""Distributed set operations and DISTINCT of materialized rows.

Counterpart of ``aquery2_tpu/engine/dist_setop.py``. EXCEPT [ALL],
INTERSECT [ALL] and the DISTINCT of a UNION compare whole row tuples.
Both inputs are results, whole on every rank; their rows, concatenated
(left, then right), are cut into the ranks' blocks, and each rank sends
its rows to the rank their tuple hashes to (one split-size all_to_all),
so equal tuples meet on one rank. There one sort by (tuple, global row
index) makes each tuple a run whose left rows lead, in left order, and
per run

  pos       each row's place in its run (a running max of the run starts:
            seg_scan_multi),
  right     the run's right rows (a segmented count, seg_cumsum_i64,
            carried back to every row of the run by a reversed segmented
            max, seg_scan_multi),

decide which left rows stay:

  EXCEPT          the first of a tuple with no right row
  EXCEPT ALL      the left rows ranked at or past the right count
  INTERSECT       the first of a tuple with a right row
  INTERSECT ALL   the left rows ranked below the right count
  DISTINCT        the first of every tuple (one input)

One all_gather of the kept row indices gives every rank the output: the
left table's rows in their order (DISTINCT in the key order of
executor._distinct). Tuples compare as executor._set_op compares them:
NULL equals NULL (a nullable column rides as its data, zero under NULL,
and a null flag), -0.0 equals 0.0 and NaN equals NaN (canonical floats),
the right arm's strings in the left arm's codes (-1 where the left has
none). A vector column, or a string column without a dictionary,
declines.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch.engine.eval import Value, _translate_codes
from aquery2_tpu_torch.ops import scan as S
from aquery2_tpu_torch.ops.sort import canonical_float
from aquery2_tpu_torch.parallel import comm
from aquery2_tpu_torch.parallel.dist_join import destinations
from aquery2_tpu_torch.storage.table import Table


def _lanes(left: Table, right: Table | None):
    """The comparable lanes of the concatenated rows (left's, then
    right's), or (None, reason)."""
    lcols = list(left.columns.values())
    rcols = list(right.columns.values()) if right is not None else None
    if rcols is not None and len(lcols) != len(rcols):
        return None, "column count mismatch"
    for c in lcols + (rcols or []):
        if c.is_vector:
            return None, "vector columns"
    n1 = left.nrows
    n2 = right.nrows if right is not None else 0
    lanes = []
    for j, lc in enumerate(lcols):
        rc = rcols[j] if rcols is not None else None
        if lc.sqltype.is_string or (rc is not None and rc.sqltype.is_string):
            if lc.dictionary is None or (rc is not None
                                         and rc.dictionary is None):
                return None, "string column without dictionary"
        parts = [lc.data[:n1]]
        if rc is not None:
            r = rc.data[:n2]
            if lc.sqltype.is_string and rc.dictionary is not lc.dictionary:
                r = _translate_codes(Value("row", r, rc.sqltype,
                                           rc.dictionary), lc.dictionary).data
            parts.append(r)
        dt = parts[0].dtype
        for x in parts[1:]:
            dt = torch.promote_types(dt, x.dtype)
        x = torch.cat([p.to(dt) for p in parts])
        if x.is_floating_point():
            x = canonical_float(x)
        nullable = lc.valid is not None or (rc is not None
                                            and rc.valid is not None)
        if nullable:
            def null(c, k):
                return (torch.zeros(k, dtype=torch.bool, device=x.device)
                        if c is None or c.valid is None else ~c.valid[:k])
            nulls = torch.cat([null(lc, n1)] + ([null(rc, n2)]
                                                if rc is not None else []))
            x = torch.where(nulls, torch.zeros((), dtype=x.dtype,
                                               device=x.device), x)
            lanes.append(nulls)
        lanes.append(x)
    return lanes, None


def _run(session, left: Table, right: Table | None, kind: str):
    """The kept left row indices, ascending (an int64 tensor), or None
    (the reason noted)."""
    mesh = session.mesh
    lanes, reason = _lanes(left, right)
    if lanes is None:
        session.note_dist_bail(f"set op: {reason}")
        return None
    nl = left.nrows
    total = nl + (right.nrows if right is not None else 0)
    dev = lanes[0].device
    if nl == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    session.note_spmd()
    cap = config.bucket_size(max(total, mesh.world))
    blk = cap // mesh.world
    lo = mesh.rank * blk
    hi = min(lo + blk, total)
    gidx = torch.arange(lo, max(hi, lo), dtype=torch.int64, device=dev)
    mine = [x[lo:hi] for x in lanes]
    dest = destinations(mesh, mine) if gidx.shape[0] else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    got = comm.all_to_all_v(mesh, dest, [gidx, *mine])
    gidx_r, cols_r = got[0], got[1:]
    keep_idx = torch.zeros(0, dtype=torch.int64, device=dev)
    if gidx_r.shape[0]:
        keep_idx = _keep(gidx_r, cols_r, nl, kind)
    kept, _sizes = comm.all_gather_v(mesh, [keep_idx])
    return torch.sort(kept[0]).values


def _keep(gidx, cols, nl: int, kind: str) -> torch.Tensor:
    """The global indices of the left rows this rank keeps, of the rows
    it received (every row of each of their tuples)."""
    from aquery2_tpu_torch.ops.sort import lexsort

    m = int(gidx.shape[0])
    perm, sk = lexsort([*[(c, True) for c in cols], (gidx, True)])
    gs = sk[-1]
    dif = torch.zeros(m - 1, dtype=torch.bool, device=gidx.device)
    for c in sk[:-1]:
        d = c[1:] != c[:-1]
        if c.is_floating_point():
            d &= ~(c[1:].isnan() & c[:-1].isnan())
        dif |= d
    one = torch.ones(1, dtype=torch.bool, device=gidx.device)
    flags = torch.cat([one, dif])
    idx = torch.arange(m, dtype=torch.int64, device=gidx.device)
    pos = idx - S.seg_cummax(torch.where(flags, idx, 0), None)
    is_right = gs >= nl
    cr = S.seg_cumsum(is_right.to(torch.int64), flags)
    rflags = torch.flip(torch.cat([flags[1:], one]), [0])
    last_cr = torch.flip(S.seg_cummax(
        torch.where(rflags, torch.flip(cr, [0]), -1), rflags), [0])
    is_left = ~is_right
    if kind == "except":
        keep = is_left & (pos == 0) & (last_cr == 0)
    elif kind == "except_all":
        keep = is_left & (pos >= last_cr)
    elif kind == "intersect":
        keep = is_left & (pos == 0) & (last_cr > 0)
    elif kind == "intersect_all":
        keep = is_left & (pos < last_cr)
    else:                               # distinct: one input
        keep = pos == 0
    return gs[keep]


def try_setop(session, left: Table, right: Table, kind: str) -> Table | None:
    """EXCEPT [ALL] / INTERSECT [ALL] over the mesh, or None."""
    from aquery2_tpu_torch.engine.executor import _take_table

    if session.mesh is None or len(left.columns) != len(right.columns):
        return None
    idx = _run(session, left, right, kind)
    return None if idx is None else _take_table(left, idx)


def try_distinct(session, table: Table) -> Table | None:
    """The distinct rows of a materialized table over the mesh, in
    executor._distinct's order, or None."""
    from aquery2_tpu_torch.engine.executor import _distinct, _take_table

    if session.mesh is None or table.nrows == 0:
        return None
    idx = _run(session, table, None, "distinct")
    if idx is None:
        return None
    # the first row of every tuple, put in _distinct's key order (a
    # grouping of rows that are already distinct)
    return _distinct(_take_table(table, idx))
