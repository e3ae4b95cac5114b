"""Fused star join + group-by: an FK join and a grouped aggregation
without materializing pairs.

Counterpart of ``aquery2_tpu/engine/fused_star.py`` for one device.
``SELECT d.w, count(*) FROM fact s, dim d WHERE s.k = d.k GROUP BY d.w``
needs no join output when the build (dim) side's keys are unique: each
fact row has at most one match, so the join is a per-row lookup.

  build  — the build keys' stats bound a position table over their value
           domain: domain + 1 int32 slots holding each key's build row,
           -1 where no row has the key (the last slot, which every probe
           key outside the domain maps to, included). A key held by two
           rows declines the shape (build_positions).
  probe  — one gather of the table gives each probe row its build row
           and the match flag, one gather per referenced dim column its
           values (probe).
  run    — the SELECT rewritten over one synthetic table, the probe
           table's columns plus the gathered ones (named ``__star_<col>``)
           and ``__star_match``, with ``AND __star_match`` in its WHERE,
           runs on the fused group-by (engine/fused_groupby.py).

The comma form with the equality in WHERE and the explicit NATURAL JOIN,
JOIN … ON and JOIN … USING forms all take this path; other conjuncts stay
as filters. An unaliased projection is named after the expression as
written (``d.w`` → ``w``), not after its rewrite. try_run returns None for
a shape outside the path: no GROUP BY, not two tables, no cross-table
equality, nullable columns, a non-integer key, string keys with different
dictionaries, a key domain above ``config.PERFECT_HASH_MAX_DOMAIN``, an
empty table or duplicate build keys.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import fused_groupby
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.catalog import Catalog
from aquery2_tpu_torch.storage.table import Column, Table

MATCH = "__star_match"
_TMP = "__star_tmp"


def _split_conjuncts(e: A.Expr) -> list[A.Expr]:
    if isinstance(e, A.BinOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _and_all(conds: list[A.Expr]) -> A.Expr:
    out = conds[0]
    for c in conds[1:]:
        out = A.BinOp(op="and", left=out, right=c)
    return out


def integer_key(col) -> bool:
    """A scalar column whose values index a domain: integer, bool or
    dictionary codes."""
    return not col.is_vector and not (col.data.is_floating_point()
                                      or col.data.is_complex())


def domain_codes(keys: torch.Tensor, n: int, mn: int, mx: int
                 ) -> torch.Tensor:
    """int32 [n]: key - mn for each of the first n keys in [mn, mx], and
    mx - mn + 1 (the domain's spare slot) for every other key, low or
    high. Compares in the keys' own dtype, so int32 keys are not widened;
    mx - mn < 2^31."""
    domain = mx - mn + 1
    k = keys[:n]
    if k.element_size() < 4:                # bool, int8, int16, uint8
        k = k.to(torch.int32)
    info = torch.iinfo(k.dtype)
    lo, hi = max(mn, info.min), min(mx, info.max)
    if lo > hi:
        return torch.full((n,), domain, dtype=torch.int32, device=k.device)
    off = (k - lo).to(torch.int32)          # exact where lo <= k <= hi
    if lo != mn:
        off += lo - mn
    return torch.where((k >= lo) & (k <= hi), off, domain)


def build_positions(bkey: Column, mn: int, mx: int):
    """(the position table of the build keys, unique): int32 [mx - mn + 2],
    each key's build row and -1 where no row has it; a 0-dim bool tensor,
    False where two rows share a key (the table then holds one of them)."""
    nb = bkey.nrows
    code = bkey.data[:nb].to(torch.int64) - mn
    rows = torch.arange(nb, dtype=torch.int32, device=code.device)
    pos = torch.full((mx - mn + 2,), -1, dtype=torch.int32,
                     device=code.device)
    pos[code] = rows
    # of rows sharing a key one stays in the table, so another reads back
    # a row that is not its own
    return pos, (pos[code] == rows).all()


def probe(pos: torch.Tensor, pkey: Column, mn: int,
          dim_cols: list[torch.Tensor]):
    """(match [n] bool, each dim column's value at the probe row's match)
    for the probe table's n rows. An unmatched row reads build row 0."""
    mx = mn + pos.shape[0] - 2
    midx = pos.index_select(0, domain_codes(pkey.data, pkey.nrows, mn, mx))
    match = midx >= 0
    if not dim_cols:
        return match, []
    safe = midx.clamp(min=0)
    return match, [d.index_select(0, safe) for d in dim_cols]


def _contains_agg(e) -> bool:
    if isinstance(e, A.Call):
        if e.func in fused_groupby._SIMPLE_AGGS or e.func == "count":
            return True
        return any(_contains_agg(a) for a in e.args
                   if not isinstance(a, A.Star))
    if isinstance(e, A.BinOp):
        return _contains_agg(e.left) or _contains_agg(e.right)
    if isinstance(e, A.UnaryOp):
        return _contains_agg(e.operand)
    return False


def _plan(get, has, sel: A.Select, ungrouped: bool = False):
    """The star shape of ``sel`` over the tables ``get(name)`` gives
    (``has(name)``: whether one exists), or None: (tables, build side,
    build key name, probe key name, key min, key max, the referenced dim
    columns {name: name in the rewrite}, the rewritten SELECT over the
    synthetic table) and the two tables' names. ungrouped: also take a SELECT whose every
    projection is an aggregate (the mesh's ungrouped join aggregate)."""
    if sel.assumptions or sel.distinct or sel.unions:
        return None
    if not sel.group_by and not (
            ungrouped and sel.projections and all(
                not isinstance(p.expr, A.Star) and _contains_agg(p.expr)
                for p in sel.projections)):
        return None

    # the explicit two-table JOIN forms into the comma + WHERE form
    sources = list(sel.sources)
    extra: list[A.Expr] = []
    if len(sources) == 1 and isinstance(sources[0], A.JoinSource):
        js = sources[0]
        if not (isinstance(js.left, A.TableSource)
                and isinstance(js.right, A.TableSource)
                and js.kind in ("inner", "natural")
                and has(js.left.name) and has(js.right.name)):
            return None
        la = js.left.alias or js.left.name
        ra = js.right.alias or js.right.name
        if js.on is not None:
            extra = _split_conjuncts(js.on)
        else:
            rnames = {c.lower() for c in get(js.right.name).columns}
            names = (list(js.using) if js.using else
                     [nm for nm in get(js.left.name).columns
                      if nm.lower() in rnames])
            if len(names) != 1:
                return None          # a multi-column join
            extra = [A.BinOp(op="=", left=A.ColumnRef(names[0], la),
                             right=A.ColumnRef(names[0], ra))]
        sources = [js.left, js.right]
    if (len(sources) != 2
            or not all(isinstance(s, A.TableSource) and has(s.name)
                       for s in sources)
            or (sel.where is None and not extra)):
        return None
    tables = [get(s.name) for s in sources]
    if any(t.has_nulls() for t in tables):
        return None
    aliases = [(s.alias or s.name).lower() for s in sources]

    def side_of(ref: A.ColumnRef) -> int | None:
        """The table (0 or 1) a column reference resolves to, or None."""
        if ref.table is not None:
            tl = ref.table.lower()
            for i, s in enumerate(sources):
                if tl in (aliases[i], s.name.lower()):
                    return i if ref.name in tables[i].columns else None
            return None
        hits = [i for i in (0, 1) if ref.name in tables[i].columns]
        return hits[0] if len(hits) == 1 else None

    # exactly one cross-table equality links the tables; the rest filter
    link = None
    residual = []
    for c in extra + (_split_conjuncts(sel.where)
                      if sel.where is not None else []):
        if (link is None and isinstance(c, A.BinOp) and c.op == "="
                and isinstance(c.left, A.ColumnRef)
                and isinstance(c.right, A.ColumnRef)):
            ls, rs = side_of(c.left), side_of(c.right)
            if ls is not None and rs is not None and ls != rs:
                link = {ls: c.left, rs: c.right}
                continue
        residual.append(c)
    if link is None:
        return None

    # the smaller table builds; the keys index a bounded domain
    build = 0 if tables[0].nrows <= tables[1].nrows else 1
    probe_side = 1 - build
    bt, pt = tables[build], tables[probe_side]
    bname, pname = link[build].name, link[probe_side].name
    bkey, pkey = bt.columns[bname], pt.columns[pname]
    if not (integer_key(bkey) and integer_key(pkey)):
        return None
    if ((bkey.sqltype.is_string or pkey.sqltype.is_string)
            and bkey.dictionary is not pkey.dictionary):
        return None                 # string keys in different dictionaries
    if bt.nrows == 0 or pt.nrows == 0:
        return None
    mn, mx = bkey.stats()
    if mx - mn + 1 > config.PERFECT_HASH_MAX_DOMAIN:
        return None

    dim_refs: dict[str, str] = {}   # dim column (lower case) -> its name here
    unresolvable = []

    def rewrite(e: A.Expr) -> A.Expr:
        if isinstance(e, A.ColumnRef):
            s = side_of(e)
            if s is None and e.table is None \
                    and e.name.lower() == pname.lower():
                # NATURAL JOIN's shared key: equal on both sides of a match
                s = probe_side
            if s is None:
                unresolvable.append(e)
                return e
            if s == probe_side:
                return A.ColumnRef(name=e.name, table=None)
            return A.ColumnRef(name=dim_refs.setdefault(
                e.name.lower(), f"__star_{e.name.lower()}"), table=None)
        if isinstance(e, A.BinOp):
            return A.BinOp(op=e.op, left=rewrite(e.left),
                           right=rewrite(e.right))
        if isinstance(e, A.UnaryOp):
            return A.UnaryOp(op=e.op, operand=rewrite(e.operand))
        if isinstance(e, A.Call):
            return A.Call(func=e.func, args=tuple(
                a if isinstance(a, A.Star) else rewrite(a) for a in e.args),
                distinct=e.distinct)
        return e

    out_aliases = {p.alias.lower() for p in sel.projections if p.alias}

    def rewrite_order(e: A.Expr) -> A.Expr:
        """An ORDER BY item; a bare output alias stays as it is."""
        if (isinstance(e, A.ColumnRef) and e.table is None
                and side_of(e) is None and e.name.lower() in out_aliases):
            return e
        return rewrite(e)

    new_projs = [p if isinstance(p.expr, A.Star) else A.Projection(
        expr=rewrite(p.expr),
        alias=p.alias or fused_groupby.derive_name(p.expr))
        for p in sel.projections]
    new_group = [rewrite(g) for g in sel.group_by]
    new_resid = [rewrite(c) for c in residual]
    new_having = rewrite(sel.having) if sel.having is not None else None
    new_order = [replace(o, expr=rewrite_order(o.expr))
                 for o in sel.order_by]
    if unresolvable:
        return None
    new_sel = replace(
        sel, sources=[A.TableSource(name=_TMP)],
        where=_and_all(new_resid + [A.ColumnRef(name=MATCH)]),
        group_by=new_group, projections=new_projs, having=new_having,
        order_by=new_order)
    return (tables, build, bname, pname, mn, mx, dim_refs, new_sel,
            [s.name for s in sources])


def try_run(catalog: Catalog, sel: A.Select) -> Table | None:
    """The result Table of a grouped star-join SELECT, or None where the
    shape does not fit."""
    plan = _plan(catalog.get, catalog.__contains__, sel)
    if plan is None:
        return None
    tables, build, bname, pname, mn, mx, dim_refs, new_sel, _nm = plan
    bt, pt = tables[build], tables[1 - build]
    bkey, pkey = bt.columns[bname], pt.columns[pname]
    pos, unique = build_positions(bkey, mn, mx)
    if not bool(unique):            # the duplicate check's host sync
        return None                 # duplicate build keys: not a star join
    dim_cols = [nm for nm in dim_refs if nm != bname.lower()]
    match, gathered = probe(pos, pkey, mn,
                            [bt.columns[nm].data for nm in dim_cols])

    n = pt.nrows
    tmp = Table(_TMP, pt.columns.values())
    for nm, arr in zip(dim_cols, gathered):
        src = bt.columns[nm]
        col = Column(dim_refs[nm], src.sqltype, arr, nrows=n,
                     dictionary=src.dictionary)
        # a gather keeps the values in range (stats() of a float column
        # would truncate, and raises on NaN)
        if src.data.is_floating_point():
            col._fsum = src.float_summary()
        else:
            col._stats = src.stats()
        tmp.add_column(col)
    km = dim_refs.get(bname.lower())
    if km is not None:
        # the dim key equals the probe key on every matched row
        col = Column(km, bkey.sqltype, pkey.data, nrows=n,
                     dictionary=pkey.dictionary)
        col._stats = pkey.stats()
        tmp.add_column(col)
    tmp.add_column(Column(MATCH, T.BoolT, match, nrows=n))
    got = fused_groupby.run(new_sel, tmp)
    return None if got is None else got[1]


def try_run_mesh(session, sel: A.Select):
    """The star join on a mesh session, as the JAX package runs it: the
    build table gathered whole (its key, then the columns the rewrite
    reads; it is the smaller side), the position table built on every
    rank, and each
    rank probing its block of the probe table, whose rows stay where they
    are; the rewritten SELECT then runs on engine/dist_query.py over the
    synthetic table's blocks (grouped, or ungrouped: every projection an
    aggregate). (fits, result): fits is False where the shape is not a
    star join; result is None where the distributed tier declined."""
    from aquery2_tpu_torch.engine import dist_query
    from aquery2_tpu_torch.parallel.mesh import (LocalView, block_column,
                                                 local_view)

    mesh, catalog = session.mesh, session.catalog
    views: dict[str, Table] = {}

    def get(name: str) -> Table:
        key = name.lower()
        if key not in views:
            views[key] = local_view(mesh, catalog.get(name))
        return views[key]

    plan = _plan(get, catalog.__contains__, sel, ungrouped=True)
    if plan is None:
        return False, None
    tables, build, bname, pname, mn, mx, dim_refs, new_sel, names = plan
    bt, local = tables[build], tables[1 - build]
    dim_cols = [nm for nm in dim_refs if nm != bname.lower()]
    placed = catalog.get(names[build])
    # the build key first: duplicate keys decline before the payloads move
    pos, unique = build_positions(
        session.readable(placed, {bname.lower()}).columns[bname], mn, mx)
    if not bool(unique):
        return False, None          # duplicate build keys: not a star join
    pkey = local.columns[pname]
    dims = session.readable(placed, set(dim_cols)) if dim_cols else None
    match, gathered = probe(pos, pkey, mn,
                            [dims.columns[nm].data for nm in dim_cols])
    cols = list(local.columns.values())
    for nm, arr in zip(dim_cols, gathered):
        src = bt.columns[nm]
        cols.append(block_column(dim_refs[nm], src.sqltype, arr, None,
                                 src.dictionary, src))
    km = dim_refs.get(bname.lower())
    if km is not None:
        cols.append(block_column(km, bt.columns[bname].sqltype, pkey.data,
                                 None, pkey.dictionary, pkey))
    cols.append(block_column(MATCH, T.BoolT, match, None, None, pkey))
    tmp = LocalView(_TMP, cols, local.n, local.valid, local.gidx)
    if new_sel.group_by:
        return True, dist_query.run(session, new_sel, tmp)
    return True, dist_query.run_ungrouped(session, new_sel, tmp)
