"""Distributed SQL window functions (OVER clauses) over the mesh.

Counterpart of ``aquery2_tpu/engine/dist_window.py``. Partitions are
independent, so the distributed ordered tier's recipe applies
(engine/dist_ordered.py): every rank sends each row WHERE keeps, with
the columns the statement reads, their NULL masks and the row's global
index, to the rank its PARTITION BY key hashes to; there the
single-device window code (engine/eval.py ``_window``, ops/window.py:
segmented scans over all partitions at once) runs over complete
partitions and is exact. The received rows arrive in global row order,
so the window sort's ties keep input order, as on one device. One
all_gather_v then gives every rank every row's outputs, which it puts
back in input row order by the global index, before the outer ORDER BY
and LIMIT.

Supported shape (``_plan``, the JAX package's gates and reasons): plain
row expressions and window calls over one table, every window with the
same non-empty PARTITION BY; each distinct OVER ORDER BY gets its own
sort. Frames: none, ROWS with literal bounds, or RANGE to the current
row. Functions: the frame aggregates, the ranking functions and ntile,
lag/lead with literal offsets and defaults, first/last/nth_value.
NULL-able aggregate arguments and row projections ride the shuffle with
their masks; NULL-able partition, order and WHERE columns stay on the
gathered path, where the port's own NULL ordering answers.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import fused_groupby as fg
from aquery2_tpu_torch.engine.dist_ordered import key_lanes, shuffle
from aquery2_tpu_torch.engine.eval import EvalContext, WorkingSet
from aquery2_tpu_torch.ops.sort import sort_perm
from aquery2_tpu_torch.parallel import comm
from aquery2_tpu_torch.parallel.mesh import local_view
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.table import Column, Table
from aquery2_tpu_torch.utils import base62uuid

_RANKING = {"row_number", "rank", "dense_rank", "percent_rank",
            "cume_dist", "ntile"}
_GATHER = {"lag", "lead", "first_value", "last_value", "nth_value"}
_FRAME_AGGS = {"sum", "avg", "mean", "min", "max", "count", "var", "stddev"}


def _plan(session, sel: A.Select, cols):
    """The plan dict, or None (the reason noted where the JAX package
    notes one)."""
    if (sel.group_by or sel.assumptions or sel.unions or sel.distinct
            or sel.having is not None):
        return None
    if len(sel.sources) != 1 or not isinstance(sel.sources[0], A.TableSource):
        return None

    referenced: set[str] = set()
    wins: list[A.WindowExpr] = []
    projections: list[tuple] = []       # (kind, alias, expr)
    for pr in sel.projections:
        e = pr.expr
        if isinstance(e, A.WindowExpr):
            projections.append(("win", pr.alias, e))
            wins.append(e)
            continue
        if isinstance(e, A.Star):
            return None
        if not (isinstance(e, A.ColumnRef) and e.name in cols
                and not getattr(cols[e.name], "is_vector", False)):
            try:
                fg._check_row_expr(e, cols)
            except fg.Unsupported:
                return None
        referenced |= fg._refs(e)      # a bare string column's codes pass
        projections.append(("row", pr.alias, e))
    if not wins:
        return None

    def bail(msg: str):
        session.note_dist_bail(msg)
        return None

    # one shuffle: every window shares the PARTITION BY; each distinct
    # OVER ORDER BY gets its own sort of the received rows
    part = wins[0].partition_by
    for w in wins[1:]:
        if repr(w.partition_by) != repr(part):
            return bail("window partition keys differ across projections")
    if not part:
        return bail("window without PARTITION BY")
    for k in part:
        if isinstance(k, A.ColumnRef) and k.name in cols:
            continue
        try:                            # computed partition key
            fg._check_row_expr(k, cols)
        except fg.Unsupported:
            return bail("untraceable window partition key")
    for k in part:
        referenced |= fg._refs(k)
    layouts: list[str] = []
    for w in wins:
        if repr(w.order_by) in layouts:
            continue
        layouts.append(repr(w.order_by))
        for o in w.order_by:
            try:
                fg._check_row_expr(o.expr, cols)
            except fg.Unsupported:
                return bail("untraceable window order key")
            okset = fg._refs(o.expr)
            referenced |= okset
            if any(nm in cols and cols[nm].sqltype.is_string
                   for nm in okset):
                return bail("string window order key")
    if sel.where is not None:
        try:
            fg._check_row_expr(sel.where, cols)
        except fg.Unsupported:
            return bail("untraceable WHERE")
        referenced |= fg._refs(sel.where)

    for w in wins:
        fname = w.func.func
        if w.func.distinct:
            return bail("DISTINCT window aggregate")
        if fname in _RANKING:
            if fname == "ntile" and (not w.func.args or _literal_value(
                    w.func.args[0]) is None):
                return bail("ntile requires a literal tile count")
        elif fname in _GATHER:
            a0 = w.func.args[0] if w.func.args else None
            if a0 is None or isinstance(a0, A.Star):
                return bail(f"{fname} requires an argument")
            if not (isinstance(a0, A.ColumnRef) and a0.name in cols
                    and cols[a0.name].sqltype.is_string):
                try:                    # (a string column's codes gather)
                    fg._check_row_expr(a0, cols)
                except fg.Unsupported:
                    return bail("untraceable window argument")
            referenced |= fg._refs(a0)
            for extra in w.func.args[1:]:
                if _literal_value(extra) is None:
                    return bail("non-literal window offset/default")
        elif fname in _FRAME_AGGS:
            args = [a for a in w.func.args if not isinstance(a, A.Star)]
            if fname != "count" or args:
                if not args:
                    return bail(f"{fname} requires an argument")
                try:
                    fg._check_row_expr(args[0], cols)
                except fg.Unsupported:
                    return bail("untraceable window argument")
                aset = fg._refs(args[0])
                if any(nm in cols and cols[nm].sqltype.is_string
                       for nm in aset):
                    return bail("string window aggregate argument")
                referenced |= aset
        else:
            return bail(f"unsupported window function {fname}")
        fr = w.frame
        if fr is not None:
            for b in (fr.start, fr.end):
                if b.kind in ("preceding", "following") and fr.unit == "range":
                    return bail("RANGE frame with numeric offsets")
            if fr.start.kind == "unbounded_following" or \
                    fr.end.kind == "unbounded_preceding":
                return bail("invalid window frame bounds")
        if fname in ("min", "max") and fr is not None and fr.unit == "rows":
            lo = (None if fr.start.kind == "unbounded_preceding"
                  else 0 if fr.start.kind == "current" else -fr.start.offset
                  if fr.start.kind == "preceding" else fr.start.offset)
            hi = (None if fr.end.kind == "unbounded_following"
                  else 0 if fr.end.kind == "current" else fr.end.offset
                  if fr.end.kind == "following" else -fr.end.offset)
            if lo is not None and hi is not None and not (lo <= 0 <= hi):
                return bail("bounded min/max frame excludes current row")

    # outer ORDER BY keys: output columns, or row expressions over source
    # columns (evaluated with the rows and gathered beside them)
    order_by: list[tuple] = []          # ("col", i, asc) | ("expr", e, asc)
    for item in (sel.order_by or []):
        target = None
        for i, pr in enumerate(sel.projections):
            if not isinstance(pr.expr, A.Star) and pr.expr == item.expr:
                target = i
                break
            if (isinstance(item.expr, A.ColumnRef) and item.expr.table is None
                    and pr.alias
                    and pr.alias.lower() == item.expr.name.lower()):
                target = i
                break
        if target is not None:
            order_by.append(("col", target, item.ascending))
            continue
        try:
            fg._check_row_expr(item.expr, cols)
        except fg.Unsupported:
            return bail("untraceable order key")
        oset = fg._refs(item.expr)
        if any(nm in cols and cols[nm].sqltype.is_string for nm in oset):
            return bail("string order key is not an output column")
        referenced |= oset
        order_by.append(("expr", item.expr, item.ascending))

    nullable = {nm for nm in referenced
                if nm in cols and cols[nm].valid is not None}
    if nullable:
        gate = set()
        for k in part:
            gate |= fg._refs(k)
        for w in wins:
            for o in w.order_by:
                gate |= fg._refs(o.expr)
        for kind_, what, _asc in order_by:
            if kind_ == "expr":
                gate |= fg._refs(what)
        if sel.where is not None:
            gate |= fg._refs(sel.where)
        if gate & nullable:
            return bail("NULL-able window key/order/filter columns")

    route = key_lanes(session, part, cols, "non-integer window partition key")
    if route is None:
        return None
    return {"projections": projections, "where": sel.where, "route": route,
            "col_order": sorted(referenced), "null_order": sorted(nullable),
            "order_by": order_by, "limit": sel.limit}


def _literal_value(e: A.Expr):
    if isinstance(e, A.Literal):
        return e.value
    if isinstance(e, A.UnaryOp) and e.op == "-" \
            and isinstance(e.operand, A.Literal):
        return -e.operand.value
    return None


def try_run(session, sel: A.Select, table: Table) -> Table | None:
    """The OVER query over the mesh, or None (the caller goes on to the
    other mesh tiers, then the gathered path; the reason noted)."""
    from aquery2_tpu_torch.engine.executor import (_limit_table,
                                                   _order_data, _sort_key_of,
                                                   _take_table)

    mesh = session.mesh
    local = local_view(mesh, table)
    p = _plan(session, sel, local.columns)
    if p is None:
        return None
    if local.n == 0:
        session.note_dist_bail("empty table")
        return None
    session.note_spmd()
    cols = local.columns
    col_order = p["col_order"]
    valid = local.valid
    if p["where"] is not None:
        env = {nm: cols[nm].data for nm in col_order}
        valid = valid & fg._truth(fg._as_rows(fg._row_eval(p["where"], env),
                                              valid))
    recv = shuffle(mesh, local, col_order, p["null_order"], p["route"], valid,
                   with_gidx=True)
    m = recv.n
    ctx = EvalContext(WorkingSet.from_table(recv, recv.valid.device),
                      session)
    outs = [_rows(ctx, ctx.eval(e), m) for _k, _a, e in p["projections"]]
    okeys = [_order_data(_rows(ctx, ctx.eval(e), m)[0], None, None)
             for kind, e, _asc in p["order_by"] if kind == "expr"]
    lanes = [recv.gidx[:m]] + [v[0] for v in outs] \
        + [v[1] for v in outs if v[1] is not None] + okeys
    got, _sizes = comm.all_gather_v(mesh, lanes)
    order = torch.sort(got[0]).indices          # input row order
    got = [x[order] for x in got[1:]]
    n_out = int(order.shape[0])

    names = fg.output_names([("", None, alias or fg.derive_name(e))
                             for _k, alias, e in p["projections"]])
    out = Table(f"result_{base62uuid(4)}")
    nulls = iter(got[len(outs):])
    for name, data, (_d, nl, sqltype, dictionary) in zip(names, got, outs):
        out.add_column(Column(name, sqltype, data, nrows=n_out,
                              dictionary=dictionary,
                              valid=None if nl is None else ~next(nulls)))
    if p["order_by"] and n_out:
        okey = iter(got[len(outs) + sum(v[1] is not None for v in outs):])
        keys = [(_sort_key_of(out.columns[names[what]], n_out)
                 if kind == "col" else next(okey), asc)
                for kind, what, asc in p["order_by"]]
        out = _take_table(out, sort_perm(keys, n_out))
    if p["limit"] is not None:
        out = _limit_table(out, p["limit"])
    return out


def _rows(ctx, v, m: int):
    """(data, NULL mask or None, SQL type, dictionary) of a projection's
    value over the m received rows (a scalar broadcast to them)."""
    if v.kind == "row":
        return (v.data[:m], None if v.nulls is None else v.nulls[:m],
                v.sqltype, v.dictionary)
    dev = ctx.ws.device
    dt = T.torch_dtype(v.sqltype.np_dtype)
    if v.data is None:                          # a NULL literal
        return (torch.zeros(m, dtype=dt, device=dev),
                torch.ones(m, dtype=torch.bool, device=dev), v.sqltype, None)
    return (torch.full((m,), v.data, dtype=dt, device=dev), None, v.sqltype,
            v.dictionary)
