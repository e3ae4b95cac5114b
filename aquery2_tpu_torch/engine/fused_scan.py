"""Fused ungrouped scan: SELECT … WHERE … ORDER BY … LIMIT with one host
sync.

Counterpart of ``aquery2_tpu/engine/fused_scan.py``. The general pipeline
syncs the host at each stage (the filter's count, each column, ORDER BY);
here the whole ungrouped pipeline runs as tensor ops with one sync, the
row count:

  1. WHERE and the projections over the padded columns
     (fused_groupby._row_eval);
  2. without ORDER BY, the selected rows by ``torch.nonzero`` (whose size
     is the sync); with it, one stable ops/sort.lexsort of [not selected,
     order keys...], so compaction and order come from one sort (ties in
     row order, as the general path's stable sort leaves them), and the
     count of the selected rows is the sync; an integer column key packs
     within its stats (one more sync, once per column: they are cached);
  3. each projection gathered at the first min(count, LIMIT) rows.

String columns ride as dictionary codes: equality with a literal becomes
a code comparison (looked up in the dictionary on the host), and an
ORDER BY on a string column sorts by the dictionary's ranks, gathered on
the device. Anything else (NULLs, vector columns, aggregates, windowed
calls, subqueries, LIKE, a CASE without ELSE) returns None for the
general engine.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch.engine import fused_groupby as fg
from aquery2_tpu_torch.ops.sort import lexsort
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.runtime.stats import sync
from aquery2_tpu_torch.storage.table import Column, Table
from aquery2_tpu_torch.utils import base62uuid


def _rewrite_string_literals(e: A.Expr, cols) -> A.Expr:
    """str-column = 'lit' → a comparison of codes (the literal's code from
    the dictionary; -1, which no row has, where it is absent)."""
    if isinstance(e, A.BinOp):
        if e.op in ("=", "<>"):
            for a, b in ((e.left, e.right), (e.right, e.left)):
                if (isinstance(a, A.ColumnRef) and a.name in cols
                        and cols[a.name].sqltype.is_string
                        and isinstance(b, A.Literal) and b.is_string):
                    d = cols[a.name].dictionary
                    code = d.lookup(b.value) if d is not None else -1
                    return A.BinOp(e.op, A.ColumnRef(a.name, a.table),
                                   A.Literal(code))
        return A.BinOp(e.op, _rewrite_string_literals(e.left, cols),
                       _rewrite_string_literals(e.right, cols))
    if isinstance(e, A.UnaryOp):
        return A.UnaryOp(e.op, _rewrite_string_literals(e.operand, cols))
    if isinstance(e, A.Call):
        return A.Call(e.func, tuple(
            a if isinstance(a, A.Star) else _rewrite_string_literals(a, cols)
            for a in e.args), e.distinct)
    if isinstance(e, A.CaseWhen):
        return A.CaseWhen(
            tuple((_rewrite_string_literals(c, cols),
                   _rewrite_string_literals(v, cols)) for c, v in e.whens),
            None if e.default is None
            else _rewrite_string_literals(e.default, cols))
    return e


def _check_expr(e: A.Expr, cols, allow_string: bool) -> None:
    """fused_groupby's row grammar, with string columns where they stand
    alone (a projection, an order key, a side of = or <>)."""
    if isinstance(e, A.ColumnRef):
        if e.name not in cols:
            raise fg.Unsupported("unknown column")
        c = cols[e.name]
        if c.is_vector:
            raise fg.Unsupported("vector column")
        if c.sqltype.is_string and not allow_string:
            raise fg.Unsupported("string in arithmetic")
        return
    if isinstance(e, A.BinOp) and e.op in ("=", "<>"):
        _check_expr(e.left, cols, allow_string=True)
        _check_expr(e.right, cols, allow_string=True)
        return
    if isinstance(e, A.BinOp) and e.op in ("+", "-", "*", "/", "%", "<",
                                           ">", "<=", ">=", "and", "or"):
        _check_expr(e.left, cols, allow_string=False)
        _check_expr(e.right, cols, allow_string=False)
        return
    if isinstance(e, A.UnaryOp) and e.op in ("-", "not"):
        _check_expr(e.operand, cols, allow_string=False)
        return
    if isinstance(e, A.Call) and e.func in fg._MATH:
        for a in e.args:
            _check_expr(a, cols, allow_string=False)
        return
    if isinstance(e, A.Literal):
        if e.is_string or e.value is None:
            raise fg.Unsupported("string or NULL literal")
        return
    if isinstance(e, A.CaseWhen):
        if e.default is None:
            raise fg.Unsupported("CASE without ELSE (NULL branch)")
        for cond, val in e.whens:
            _check_expr(cond, cols, allow_string=False)
            _check_expr(val, cols, allow_string=False)
        _check_expr(e.default, cols, allow_string=False)
        return
    raise fg.Unsupported(f"expr {e}")


def _plan(sel: A.Select, cols):
    """(projections [(name, expr)], where, order [(expr, asc)]) or raise
    fg.Unsupported."""
    projections: list[tuple[str, A.Expr]] = []
    for p in sel.projections:
        if isinstance(p.expr, A.Star):
            for c in cols.values():
                if c.is_vector:
                    raise fg.Unsupported("vector column in *")
                projections.append((c.name, A.ColumnRef(c.name, None)))
            continue
        e = _rewrite_string_literals(p.expr, cols)
        _check_expr(e, cols, allow_string=True)
        projections.append((p.alias or fg.derive_name(p.expr), e))
    names = fg.output_names([("", e, nm) for nm, e in projections])
    projections = list(zip(names, (e for _, e in projections)))

    where = None
    if sel.where is not None:
        where = _rewrite_string_literals(sel.where, cols)
        _check_expr(where, cols, allow_string=True)
    order: list[tuple[A.Expr, bool]] = []
    for item in sel.order_by or []:
        e = item.expr
        if isinstance(e, A.ColumnRef) and e.table is None \
                and e.name not in cols:
            for nm, pe in projections:      # an alias → its expression
                if nm.lower() == e.name.lower():
                    e = pe
                    break
        e = _rewrite_string_literals(e, cols)
        _check_expr(e, cols, allow_string=True)
        order.append((e, item.ascending))
    return projections, where, order


def try_run(catalog, sel: A.Select) -> Table | None:
    """The fused scan of an ungrouped single-table SELECT, or None."""
    if (sel.group_by or sel.assumptions or sel.distinct or sel.unions
            or sel.having or len(sel.sources) != 1
            or not isinstance(sel.sources[0], A.TableSource)
            or sel.sources[0].name not in catalog):
        return None
    table = catalog.get(sel.sources[0].name)
    cols = table.columns
    n = table.nrows
    if n == 0:
        return None
    try:
        projections, where, order = _plan(sel, cols)
    except fg.Unsupported:
        return None
    referenced = set()
    for e in [*(e for _, e in projections), where, *(e for e, _ in order)]:
        if e is not None:
            referenced |= fg._refs(e)
    if table.has_nulls(referenced):
        return None

    env = {nm: cols[nm].data for nm in referenced}
    dev = next(iter(cols.values())).device
    cap = next(iter(cols.values())).capacity
    valid = torch.arange(cap, device=dev) < n
    if where is not None:
        valid = valid & fg._truth(fg._as_rows(fg._row_eval(where, env),
                                              valid))
    if order:
        keys = [(~valid, True)]
        for e, asc in order:
            k = fg._as_rows(fg._row_eval(e, env), valid)
            key = (k, asc)
            src = cols[e.name] if isinstance(e, A.ColumnRef) else None
            if src is not None and src.sqltype.is_string \
                    and src.dictionary is not None and len(src.dictionary):
                ranks = torch.from_numpy(src.dictionary.ranks).to(dev)
                key = (ranks[k.clamp(0, len(ranks) - 1).long()], asc,
                       (0, len(ranks) - 1))
            elif src is not None and not k.is_floating_point() \
                    and k.dtype != torch.bool:
                # bounded by the column's (cached) stats, the keys pack
                # into fewer bits: fewer sorts
                key = (k, asc, src.stats())
            keys.append(key)
        idx = lexsort(keys)[0]
        with sync("scan.count"):            # the one sync
            m = int(valid.sum())
    else:
        with sync("scan.count"):            # the one sync
            idx = torch.nonzero(valid).squeeze(1)
        m = int(idx.shape[0])
    if sel.limit is not None:
        m = min(m, sel.limit)
    idx = idx[:m]

    out = Table(f"result_{base62uuid(4)}")
    for nm, e in projections:
        arr = fg._as_rows(fg._row_eval(e, env), valid)[idx]
        if isinstance(e, A.ColumnRef):
            src = cols[e.name]
            out.add_column(Column(nm, src.sqltype, arr, nrows=m,
                                  dictionary=src.dictionary))
        else:
            out.add_column(Column(nm, fg.sql_type(arr), arr, nrows=m))
    return out
