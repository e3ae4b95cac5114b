"""The materialized distributed equi-join, then a distributed tier over it.

Counterpart of ``aquery2_tpu/engine/dist_join_query.py``: the two-table
equi-joins the star join declines (duplicate build keys, wide key
domains, outer joins) on a mesh session. Both sides' rows move to the
rank their key hashes to and each rank joins what it received
(parallel/dist_join.dist_equijoin_outer, with engine/join.py's probe);
every rank then holds its own pairs, a ragged block of the join, as a
synthetic table {__jk, __l_<col>, __r_<col>}, and the rewritten SELECT
runs on engine/dist_query.py (GROUP BY or all-aggregate projections) or
engine/dist_scan.py (row projections) over those blocks.

Shapes, as the JAX package takes them: one cross-table equality link
(from ON for an outer join), INNER, LEFT, RIGHT (sides swapped into
LEFT) or FULL; other WHERE conjuncts filter an inner join's pairs, and an
outer join with one declines. Integer or shared-dictionary string keys.
A NULL-extended side's key column cannot be read (__jk holds the
preserved side's key), nor can nullable or vector columns: each declines,
and the query runs on gathered tables. Output columns are named as the
projections are written (``d.w`` → ``w``), where the JAX package shows
its rewrite (``__jk``, ``sum___r_w``).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from aquery2_tpu_torch.engine.fused_groupby import derive_name
from aquery2_tpu_torch.engine.fused_star import _contains_agg
from aquery2_tpu_torch.parallel.dist_join import dist_equijoin_outer
from aquery2_tpu_torch.parallel.mesh import (LocalView, block_column,
                                             local_view)
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.table import Table

_TMP = "__dist_join_tmp"


def _split_conjuncts(e):
    if isinstance(e, A.BinOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _and_all(conds):
    out = None
    for c in conds:
        out = c if out is None else A.BinOp(op="and", left=out, right=c)
    return out


def try_run(session, sel: A.Select) -> Table | None:
    """The join query over the mesh, or None (declined; the reason noted
    where the JAX package notes one)."""
    mesh = session.mesh
    catalog = session.catalog
    if mesh is None or sel.assumptions or sel.distinct or sel.unions:
        return None

    sources = list(sel.sources)
    extra_conds: list[A.Expr] = []
    jkind = "inner"
    if len(sources) == 1 and isinstance(sources[0], A.JoinSource):
        js = sources[0]
        if not (isinstance(js.left, A.TableSource)
                and isinstance(js.right, A.TableSource)
                and js.kind in ("inner", "natural", "left", "right",
                                "full")):
            return None
        if js.left.name not in catalog or js.right.name not in catalog:
            return None
        lt, rt = catalog.get(js.left.name), catalog.get(js.right.name)
        la = js.left.alias or js.left.name
        ra = js.right.alias or js.right.name
        if js.on is not None:
            extra_conds = _split_conjuncts(js.on)
        else:
            rnames = {c.lower() for c in rt.column_names()}
            names = (list(js.using) if js.using else
                     [nm for nm in lt.column_names()
                      if nm.lower() in rnames])
            if len(names) != 1:
                return None
            extra_conds = [A.BinOp(
                op="=", left=A.ColumnRef(name=names[0], table=la),
                right=A.ColumnRef(name=names[0], table=ra))]
        sources = [js.left, js.right]
        if js.kind == "right":
            sources = [js.right, js.left]
            jkind = "left"
        elif js.kind in ("left", "full"):
            jkind = js.kind
    if len(sources) != 2 or not all(isinstance(s, A.TableSource)
                                    for s in sources):
        return None
    if not all(s.name in catalog for s in sources):
        return None
    tables = [catalog.get(s.name) for s in sources]
    aliases = [(s.alias or s.name).lower() for s in sources]

    row_projection = False
    if not sel.group_by:
        if not sel.projections or any(isinstance(p.expr, A.Star)
                                      for p in sel.projections):
            return None
        n_agg = sum(_contains_agg(p.expr) for p in sel.projections)
        if n_agg == 0:
            row_projection = True
        elif n_agg != len(sel.projections):
            return None

    def side_of(ref: A.ColumnRef):
        if ref.table is not None:
            tl = ref.table.lower()
            for i, s in enumerate(sources):
                if tl in (aliases[i], s.name.lower()):
                    return i if ref.name in tables[i].columns else None
            return None
        hits = [i for i in (0, 1) if ref.name in tables[i].columns]
        return hits[0] if len(hits) == 1 else None

    # one cross-table equality link; for an outer join it must come from
    # ON (a WHERE equality filters after the NULL extension)
    conds = extra_conds + (_split_conjuncts(sel.where)
                           if sel.where is not None else [])
    link = None
    residual = []
    for i, c in enumerate(conds):
        linkable = jkind == "inner" or i < len(extra_conds)
        if (link is None and linkable and isinstance(c, A.BinOp)
                and c.op == "="
                and isinstance(c.left, A.ColumnRef)
                and isinstance(c.right, A.ColumnRef)):
            ls, rs = side_of(c.left), side_of(c.right)
            if ls is not None and rs is not None and ls != rs:
                link = ((c.left, ls), (c.right, rs))
                continue
        residual.append(c)
    if link is None:
        return None
    if jkind != "inner" and residual:
        session.note_dist_bail("outer join with residual predicates")
        return None

    (refa, sa), (refb, sb) = link
    key_by_side = {sa: refa, sb: refb}
    kcols = [tables[i].columns[key_by_side[i].name] for i in (0, 1)]
    for kc in kcols:
        if kc.is_vector or kc.sqltype.kind == "float":
            return None
    if kcols[0].sqltype.is_string or kcols[1].sqltype.is_string:
        if kcols[0].dictionary is not kcols[1].dictionary:
            return None          # dictionary translation: gathered path

    null_sides = {"inner": frozenset(), "left": frozenset({1}),
                  "full": frozenset({0, 1})}[jkind]
    key_names = {i: key_by_side[i].name.lower() for i in (0, 1)}
    payloads: dict[int, dict[str, str]] = {0: {}, 1: {}}
    unresolvable = []

    def rewrite(e):
        if isinstance(e, A.ColumnRef):
            s = side_of(e)
            if s is None:
                unresolvable.append(e)
                return e
            if e.name.lower() == key_names[s]:
                if s in null_sides:
                    unresolvable.append(e)
                    return e
                return A.ColumnRef(name="__jk", table=None)
            mang = payloads[s].setdefault(
                e.name.lower(), f"__{'lr'[s]}_{e.name.lower()}")
            return A.ColumnRef(name=mang, table=None)
        if isinstance(e, A.BinOp):
            return A.BinOp(op=e.op, left=rewrite(e.left),
                           right=rewrite(e.right))
        if isinstance(e, A.UnaryOp):
            return A.UnaryOp(op=e.op, operand=rewrite(e.operand))
        if isinstance(e, A.Call):
            return A.Call(func=e.func,
                          args=tuple(a if isinstance(a, A.Star)
                                     else rewrite(a) for a in e.args),
                          distinct=e.distinct)
        return e

    new_group = [rewrite(g) for g in sel.group_by]
    # output names as written (d.w → w), not as rewritten (__r_w)
    new_projs = [A.Projection(expr=rewrite(p.expr),
                              alias=p.alias or derive_name(p.expr))
                 for p in sel.projections]
    new_resid = [rewrite(c) for c in residual]
    new_having = rewrite(sel.having) if sel.having is not None else None
    new_order = [replace(o, expr=rewrite(o.expr))
                 for o in (sel.order_by or [])]
    if unresolvable:
        return None

    for s in (0, 1):
        for nm in list(payloads[s]) + [key_names[s]]:
            c = tables[s].columns[nm]
            if c.is_vector or tables[s].has_nulls([nm]):
                session.note_dist_bail(
                    "NULL/vector columns in distributed join")
                return None
    if not tables[0].nrows or not tables[1].nrows:
        session.note_dist_bail("capacity not divisible by mesh size")
        return None

    views = [local_view(mesh, t) for t in tables]
    lnames, rnames = sorted(payloads[0]), sorted(payloads[1])
    lv, rv = views
    key, louts, routs, lnull, rnull = dist_equijoin_outer(
        mesh, lv.columns[key_names[0]].data, lv.valid,
        [lv.columns[nm].data for nm in lnames],
        rv.columns[key_names[1]].data, rv.valid,
        [rv.columns[nm].data for nm in rnames],
        emit_left=jkind in ("left", "full"), emit_right=jkind == "full")
    m = int(key.shape[0])
    dev = key.device
    ok = torch.ones(m, dtype=torch.bool, device=dev)
    if m == 0:            # no pair here: one invalid row keeps the shapes
        key = torch.zeros(1, dtype=key.dtype, device=dev)
        louts = [torch.zeros(1, dtype=x.dtype, device=dev) for x in louts]
        routs = [torch.zeros(1, dtype=x.dtype, device=dev) for x in routs]
        lnull = rnull = ok = torch.zeros(1, dtype=torch.bool, device=dev)

    src_key = tables[0].columns[key_names[0]]
    cols = [block_column("__jk", src_key.sqltype,
                         key.to(lv.columns[key_names[0]].data.dtype), None,
                         src_key.dictionary, _JoinKeyStats(kcols))]
    for nm, arr in zip(lnames, louts):
        src = tables[0].columns[nm]
        cols.append(block_column(payloads[0][nm], src.sqltype, arr,
                                 ~lnull if jkind == "full" else None,
                                 src.dictionary, src))
    for nm, arr in zip(rnames, routs):
        src = tables[1].columns[nm]
        cols.append(block_column(payloads[1][nm], src.sqltype, arr,
                                 ~rnull if jkind != "inner" else None,
                                 src.dictionary, src))
    total = int(_global_rows(mesh, m, dev))
    gidx = mesh.rank * (1 << 40) + torch.arange(ok.shape[0], device=dev)
    tmp = LocalView(_TMP, cols, total, ok, gidx)

    new_sel = replace(
        sel, sources=[A.TableSource(name=_TMP, alias=None)],
        where=_and_all(new_resid), group_by=list(new_group),
        projections=list(new_projs), having=new_having,
        order_by=list(new_order))

    from aquery2_tpu_torch.engine import dist_query, dist_scan

    if new_sel.group_by:
        return dist_query.run(session, new_sel, tmp)
    if row_projection:
        return dist_scan.try_run(session, new_sel, tmp)
    return dist_query.run_ungrouped(session, new_sel, tmp)


class _JoinKeyStats:
    """The join key's global stats: the two key columns' hull."""

    def __init__(self, kcols) -> None:
        self.kcols = kcols

    def stats(self):
        a, b = self.kcols[0].stats(), self.kcols[1].stats()
        return min(a[0], b[0]), max(a[1], b[1])

    def float_summary(self):
        return self.kcols[0].float_summary()


def _global_rows(mesh, m: int, dev) -> int:
    """The join's row count over every rank (one all_reduce)."""
    from aquery2_tpu_torch.parallel import comm

    return comm.all_reduce(mesh, torch.tensor([m], dtype=torch.int64,
                                              device=dev), "sum")[0]
