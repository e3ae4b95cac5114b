"""Distributed ungrouped scans: ORDER BY … LIMIT (top-k), and scans
without a limit.

Counterpart of ``aquery2_tpu/engine/dist_scan.py``: SELECT row-exprs FROM
t [WHERE …] [ORDER BY …] [LIMIT L] over the ranks' blocks, in the
single-device fused scan's grammar (engine/fused_scan._plan: string
columns as dictionary codes, ORDER BY on a string by its rank).

  top-k      (LIMIT ≤ MAX_LIMIT) each rank filters and evaluates its rows,
             sorts them by [not selected, order keys…, global row index]
             and keeps its first L (a rank gives at most L rows to the
             global first L); one all_gather of those candidates and one
             sort of them give every rank the answer.
  unbounded  (no LIMIT, or a larger one) each rank's selected rows, with
             their order keys and row index, are gathered to every rank
             and sorted there: every rank returns the whole result, as
             the JAX package's lanes replicate under several processes.

Ties keep the table's row order (the global row index breaks them), as
the single-device scan's stable sort leaves them. The table may be a
rank's view of a joined buffer (engine/dist_join_query.py), whose
validity is ragged.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.engine import fused_groupby as fg
from aquery2_tpu_torch.engine import fused_scan as fs
from aquery2_tpu_torch.engine.dist_query import table_rows
from aquery2_tpu_torch.ops.sort import lexsort
from aquery2_tpu_torch.parallel import comm
from aquery2_tpu_torch.parallel.mesh import local_view
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.table import Column, Table
from aquery2_tpu_torch.utils import base62uuid

MAX_LIMIT = 1 << 17         # the top-k merge holds world · L candidates


def try_run(session, sel: A.Select, table: Table) -> Table | None:
    """The scan over the mesh, or None (the reason noted where the JAX
    package notes one)."""
    mesh = session.mesh
    if mesh is None:
        return None
    if (sel.group_by or sel.assumptions or sel.distinct or sel.unions
            or sel.having or sel.into_outfile):
        return None
    if table_rows(table) == 0:
        session.note_dist_bail("empty table")
        return None
    cols = table.columns
    try:
        projections, where, order = fs._plan(sel, cols)
    except fg.Unsupported as e:
        session.note_dist_bail(f"unsupported scan shape: {e}")
        return None
    referenced: set[str] = set()
    for e in [*(e for _, e in projections), where, *(e for e, _ in order)]:
        if e is not None:
            referenced |= fg._refs(e)
    if table.has_nulls(referenced):
        session.note_dist_bail("NULL columns in distributed scan")
        return None
    if not referenced:
        session.note_dist_bail("no referenced columns in distributed scan")
        return None
    session.note_spmd()

    local = local_view(mesh, table)
    lcols = local.columns
    env = {nm: lcols[nm].data for nm in referenced}
    valid = local.valid
    if where is not None:
        valid = valid & fg._truth(fg._as_rows(fg._row_eval(where, env),
                                              valid))
    projs = [fg._as_rows(fg._row_eval(e, env), valid)
             for _, e in projections]
    okeys, entries = [], []
    for e, asc in order:
        k = fg._as_rows(fg._row_eval(e, env), valid)
        src = lcols[e.name] if isinstance(e, A.ColumnRef) else None
        bound = None
        if src is not None and src.sqltype.is_string \
                and src.dictionary is not None and len(src.dictionary):
            ranks = torch.from_numpy(src.dictionary.ranks).to(k.device)
            k = ranks[k.clamp(0, len(ranks) - 1).long()]
            bound = (0, len(ranks) - 1)
        elif src is not None and not k.is_floating_point() \
                and k.dtype != torch.bool:
            bound = src.stats()
        okeys.append(k)
        entries.append((asc, bound))

    def ents(keys, gidx):
        return [(k, asc) if b is None else (k, asc, b)
                for k, (asc, b) in zip(keys, entries)] + [(gidx, True)]

    limit = sel.limit
    if limit is not None and limit <= MAX_LIMIT:
        perm = lexsort([(~valid, True), *ents(okeys, local.gidx)])[0]
        take = perm[:min(limit, int(perm.shape[0]))]
        take = take[valid[take]]            # this rank's top rows
    else:
        take = torch.nonzero(valid).squeeze(1)
    lanes = [x[take] for x in [*okeys, local.gidx, *projs]]
    got, _sizes = comm.all_gather_v(mesh, lanes)
    no = len(okeys)
    gk, gidx, gp = got[:no], got[no], got[no + 1:]
    order_idx = lexsort(ents(gk, gidx))[0]
    m = int(order_idx.shape[0])
    if limit is not None:
        m = min(m, limit)
    order_idx = order_idx[:m]

    out = Table(f"result_{base62uuid(4)}")
    for (nm, e), arr in zip(projections, gp):
        arr = arr[order_idx]
        if isinstance(e, A.ColumnRef):
            src = cols[e.name]
            out.add_column(Column(nm, src.sqltype, arr, nrows=m,
                                  dictionary=src.dictionary))
        else:
            out.add_column(Column(nm, fg.sql_type(arr), arr, nrows=m))
    return out
