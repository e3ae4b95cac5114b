"""Statement executor: DDL, DML and SELECT against a Session.

Counterpart of ``aquery2_tpu/engine/executor.py`` on one device. A SELECT
takes the first of these that covers it, in the JAX package's order:

  1. SELECT DISTINCT of plain expressions, rewritten as GROUP BY;
  2. a set operation: each arm as its own SELECT, the results appended
     (UNION ALL), deduplicated (UNION), or compared row for row (EXCEPT
     [ALL], INTERSECT [ALL], ``_set_op``);
  3. one table, grouped: the fused group-by (engine/fused_groupby.py),
     then the ordered group-by (engine/fused_ordered.py);
  4. two tables: the star join (engine/fused_star.py), then, without
     GROUP BY, the count join (engine/fused_join.py);
  5. one table, ungrouped, no ASSUMING: the fused scan
     (engine/fused_scan.py);
  6. the general pipeline over the FROM clause's sources, joined by
     engine/join.py (NATURAL, USING, ON, LEFT/RIGHT/FULL, comma-joins
     whose WHERE equalities become keys), and derived tables:

       sources → ASSUMING sort → WHERE compaction → GROUP BY
       → projections (engine/eval.py) → HAVING → set operations
       → DISTINCT → ORDER BY → LIMIT → INTO

Every step runs on the session's device; the host reads only counts (the
join's candidates and pairs, the WHERE and HAVING compactions, the group
count, the kept rows of a set operation, the keys' stats, a vector
column's value count) and scalars (LIMIT, subquery results).

Statements: CREATE TABLE [AS SELECT], DROP TABLE, INSERT (values, computed
values, SELECT), DELETE, UPDATE, CREATE INDEX and CACHE TABLE (no-ops:
scans are always vectorized, tables always on the device) and <sql>
passthrough blocks.

CREATE [AGGREGATION] FUNCTION registers a user function
(engine/udf.py); accumulation-loop AGGREGATION FUNCTION calls are
rewritten into aggregates before the tiers (engine/udf_rewrite.py);
any other call runs its body in the general pipeline
(engine/udf_device.py, through eval).

LOAD [COMPLEX] DATA INFILE appends a CSV file to a table
(storage/csvio.py); SELECT … INTO OUTFILE writes the result, on every
route, as a CSV file without a header. Paths resolve under the session's
``base_dir``. LOAD MODULE registers a module's functions (sdk/modules.py);
CREATE/DROP TRIGGER go to the session's trigger host
(runtime/triggers.py), and every LOAD and INSERT then notifies it.

On a mesh session (parallel/mesh.py) each SELECT is counted as the JAX
package counts it (``run_select``): the distributed tiers come first at
the JAX package's places (engine/dist_query.py for one grouped or
ungrouped table, the star join's and the count join's mesh branches,
engine/dist_ordered.py for the median and the ordered (ASSUMING) group-bys,
engine/dist_window.py for OVER windows, engine/dist_join_query.py for
other two-table equi-joins, engine/dist_scan.py for ungrouped scans,
engine/dist_setop.py for EXCEPT, INTERSECT and DISTINCT of materialized
rows), and whatever they decline runs the single-device tiers over
tables gathered back whole (``_cat``: the columns the statement names,
all-gathered once per statement). A statement that changes a table
(LOAD, INSERT, DELETE, UPDATE, CREATE TABLE AS) places it again.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import (dist_join_query, dist_ordered,
                                      dist_query, dist_scan, dist_setop,
                                      dist_window, fused_groupby, fused_join,
                                      fused_ordered, fused_scan, fused_star)
from aquery2_tpu_torch.engine import join as join_mod
from aquery2_tpu_torch.engine import groupby as gb
from aquery2_tpu_torch.engine import grouped_agg, udf_device, udf_rewrite
from aquery2_tpu_torch.engine.eval import (AGG_NAMES, EvalContext, Value,
                                           WorkingSet, _host_scalar,
                                           _translate_codes)
from aquery2_tpu_torch.engine.udf import Udf
from aquery2_tpu_torch.ops import filter as filter_ops
from aquery2_tpu_torch.ops import ragged
from aquery2_tpu_torch.ops import scan as S
from aquery2_tpu_torch.ops.reduce import big_of, small_of
from aquery2_tpu_torch.ops.sort import sort_perm
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.runtime.stats import note_tier, span, sync
from aquery2_tpu_torch.storage import csvio
from aquery2_tpu_torch.storage.result import Result
from aquery2_tpu_torch.storage.table import (Column, StringDict, Table,
                                             VectorColumn, recode)
from aquery2_tpu_torch.utils import base62uuid


class ExecError(Exception):
    pass


class Executor:
    def __init__(self, session) -> None:
        self.session = session
        self._view = None               # a mesh statement's gathered tables

    def _cat(self):
        """The catalog as single-device code reads it: on a mesh session
        the statement's view, whose tables are gathered whole."""
        return self._view if self._view is not None else self.session.catalog

    def _store(self, tbl: Table) -> None:
        """A table this statement changed: back into the catalog and, on
        a mesh session, placed over the ranks again."""
        if self.session.mesh is not None:
            self.session.catalog.create(tbl, replace=True)
            self._view.forget(tbl.name)
            self.session.place_table(tbl)

    # ------------------------------------------------------------------ #
    # statements
    # ------------------------------------------------------------------ #

    def execute(self, stmt: A.Statement) -> Result | None:
        mesh = self.session.mesh
        if mesh is None or self._view is not None:
            return self._execute(stmt)
        mesh.log.reset()                # last_query_comm: this statement
        self._view = _GatheredCatalog(self.session, _statement_columns(stmt))
        try:
            return self._execute(stmt)
        finally:
            self._view = None

    def _execute(self, stmt: A.Statement) -> Result | None:
        catalog = self._cat()
        if isinstance(stmt, A.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, A.DropTable):
            with span("catalog"):
                catalog.drop(stmt.name, if_exists=stmt.if_exists)
            return None
        if isinstance(stmt, A.Insert):
            return self._insert(stmt)
        if isinstance(stmt, A.Delete):
            return self._delete(stmt)
        if isinstance(stmt, A.Update):
            return self._update(stmt)
        if isinstance(stmt, A.Select):
            return Result(self.run_select(stmt))
        if isinstance(stmt, (A.CreateIndex, A.CacheTable)):
            return None
        if isinstance(stmt, A.PassthroughSQL):
            # the reference forwards these to MonetDB; here they are SQL
            # this engine runs
            from aquery2_tpu_torch.parser import parse

            last = None
            for s in parse(stmt.text):
                r = self.execute(s)
                if r is not None:
                    last = r
            return last
        if isinstance(stmt, A.CreateFunction):
            self.session.udfs[stmt.name.lower()] = Udf(stmt)
            return None
        if isinstance(stmt, A.Load):
            tbl = catalog.get(stmt.table)
            csvio.load_csv_into(tbl, self.session.resolve_path(stmt.path),
                                field_sep=stmt.field_sep,
                                element_sep=stmt.element_sep,
                                complex_cells=stmt.complex)
            self._store(tbl)
            self.session.notify_insert(tbl.name)
            return None
        if isinstance(stmt, A.LoadModule):
            from aquery2_tpu_torch.sdk import modules

            modules.load_module(self.session, stmt)
            return None
        if isinstance(stmt, A.CreateTrigger):
            self.session.triggers.create(stmt)
            return None
        if isinstance(stmt, A.DropTrigger):
            self.session.triggers.drop(stmt.name)
            return None
        raise ExecError(f"cannot execute {type(stmt).__name__}")

    def _create_table(self, stmt: A.CreateTable) -> None:
        catalog = self._cat()
        if stmt.as_select is not None:
            tbl = self.run_select(stmt.as_select)
            tbl.name = stmt.name
            with span("catalog"):
                catalog.create(tbl, replace=True)
            self._store(tbl)
            return None
        dev = self.session.device
        cols = []
        for cd in stmt.columns:
            t = T.from_sql_name(cd.type_name)
            cols.append(Column.from_host(
                cd.name, t, [], device=dev,
                dictionary=StringDict() if t.is_string else None))
        catalog.create(Table(stmt.name, cols))
        return None

    def _insert(self, stmt: A.Insert) -> None:
        tbl = self._cat().get(stmt.table)
        if stmt.select is not None:
            tbl.append_table(self.run_select(stmt.select))
            self._store(tbl)
            self.session.notify_insert(tbl.name)
            return None
        rows = []
        for row in stmt.values:
            vals = []
            for e in row:
                if isinstance(e, A.Literal):
                    vals.append(e.value)
                elif (isinstance(e, A.UnaryOp) and e.op == "-"
                        and isinstance(e.operand, A.Literal)):
                    vals.append(-e.operand.value)
                else:                       # a computed value
                    v = EvalContext(self._empty_ws(), self.session).eval(e)
                    vals.append(_host_scalar(v.data))
            rows.append(vals)
        if stmt.columns:
            order = [c.lower() for c in stmt.columns]
            names = [c.lower() for c in tbl.column_names()]
            if set(order) != set(names):
                raise ExecError("INSERT column list must cover all columns")
            perm = [order.index(nm) for nm in names]
            rows = [[r[i] for i in perm] for r in rows]
        tbl.append_rows(rows)
        self._store(tbl)
        self.session.notify_insert(tbl.name)
        return None

    def _where_mask(self, ctx: EvalContext, where: A.Expr) -> torch.Tensor:
        """[capacity] bool: the rows where ``where`` is TRUE (not false,
        not NULL) among the first ws.n."""
        mv = ctx.to_row(ctx.eval(where))
        mask = _bool_rows(mv.data, ctx.ws)
        if mv.nulls is not None:
            mask = mask & ~mv.nulls
        return mask & (torch.arange(ctx.ws.capacity, device=ctx.ws.device)
                       < ctx.ws.n)

    def _delete(self, stmt: A.Delete) -> None:
        tbl = self._cat().get(stmt.table)
        n = tbl.nrows
        if stmt.where is None:
            keep = torch.zeros(0, dtype=torch.int64, device=self.session.device)
        else:
            ws = WorkingSet.from_table(tbl, self.session.device)
            gone = self._where_mask(EvalContext(ws, self.session), stmt.where)
            keep, _m = filter_ops.compact_indices(~gone[:n])
        out = _take_table(tbl, keep)
        tbl.columns = out.columns
        self._store(tbl)
        return None

    def _update(self, stmt: A.Update) -> None:
        """UPDATE t SET c = expr [, ...] [WHERE cond]: a masked overwrite of
        the device columns. Every right-hand side reads the old row."""
        tbl = self._cat().get(stmt.table)
        ws = WorkingSet.from_table(tbl, self.session.device)
        ctx = EvalContext(ws, self.session)
        if stmt.where is not None:
            mask = self._where_mask(ctx, stmt.where)
        else:
            mask = torch.arange(ws.capacity, device=ws.device) < ws.n
        new = [(tbl.columns[c], ctx.to_row(ctx.eval(e)))
               for c, e in stmt.assignments]
        for col, nv in new:
            if col.is_vector:
                raise ExecError("UPDATE of vector columns not supported")
            data = nv.data
            if data is None:                    # SET c = NULL
                data = 0
                nv = Value("scalar", 0, col.sqltype, nulls=torch.ones(
                    ws.capacity, dtype=torch.bool, device=ws.device))
            if col.sqltype.is_string:
                d = col.dictionary
                if isinstance(data, str):
                    data = d.encode_one(data)
                else:
                    data = recode(data, nv.dictionary, d)
            if not isinstance(data, torch.Tensor):
                data = torch.tensor(data, device=ws.device)
            old = col.data[:ws.capacity]
            out = torch.where(mask, data.to(old.dtype), old)
            valid = None
            if col.valid is not None or nv.nulls is not None:
                ones = torch.ones(ws.capacity, dtype=torch.bool,
                                  device=ws.device)
                new_ok = ones if nv.nulls is None else ~nv.nulls
                valid = torch.where(mask, new_ok,
                                    ones if col.valid is None else col.valid)
            tbl.columns[col.name] = Column(col.name, col.sqltype, out,
                                           nrows=tbl.nrows,
                                           dictionary=col.dictionary,
                                           valid=valid)
        self._store(tbl)
        return None

    def _empty_ws(self) -> WorkingSet:
        """One row and no columns: the source of a SELECT with no FROM."""
        return WorkingSet([("__dual__", Table("__dual__"))], [None], 1, 1,
                          self.session.device)

    # ------------------------------------------------------------------ #
    # SELECT
    # ------------------------------------------------------------------ #

    def run_select(self, sel: A.Select) -> Table:
        session = self.session
        if session.mesh is None:
            table = self._select(sel)
        else:
            # whether a distributed tier ran this SELECT (nested SELECTs
            # count on their own), as the JAX package accounts it
            prev = (session._dist_hit, session._dist_reason)
            session._dist_hit, session._dist_reason = False, None
            try:
                table = self._select(sel)
            finally:
                if session._dist_hit:
                    session.stats.dist_spmd += 1
                else:
                    session._record_mesh_fallback(
                        session._dist_reason or "query class not distributed")
                session._dist_hit, session._dist_reason = prev
        if sel.into_table:
            table.name = sel.into_table
            self._cat().create(table, replace=True)
        if sel.into_outfile:
            Result(table).to_csv(self.session.resolve_path(sel.into_outfile),
                                 sep=sel.outfile_sep, header=False)
        return table

    def _select(self, sel: A.Select) -> Table:
        session = self.session
        mesh = session.mesh
        placed = session.catalog            # placed tables: the dist tiers
        catalog = self._cat()
        with span("plan"):
            sel = _resolve_positions(sel, session.udfs)
            if session.udfs:
                # accumulation-loop AGGREGATION FUNCTIONs become aggregate
                # expressions first, so that every tier below runs them
                sel2 = udf_rewrite.rewrite_select(session, sel)
                if sel2 is not None:
                    sel = sel2
            sel2 = _distinct_to_groupby(sel, placed)
            if sel2 is not None:
                sel = sel2
        if sel.unions:
            t = self._run_union(sel)
            if t is not None:
                return t
        srcs = sel.sources
        one_table = (len(srcs) == 1 and isinstance(srcs[0], A.TableSource)
                     and srcs[0].name in catalog)
        if sel.group_by and one_table and mesh is not None:
            table = placed.get(srcs[0].name)
            t = dist_query.run(session, sel, table)
            if t is None:
                t = dist_ordered.run_ordered(session, sel, table)
            if t is not None:
                return t
        if sel.group_by and one_table:
            table = catalog.get(srcs[0].name)
            got = fused_groupby.run(sel, table)
            t = None if got is None else _answered(*got)
            if t is None:
                t = _answered("ordered", fused_ordered.run(sel, table))
            if t is not None:
                return t
        if len(srcs) > 1 or any(isinstance(s, A.JoinSource) for s in srcs):
            t = None
            if not sel.assumptions and mesh is None:
                t = _answered("star", fused_star.try_run(catalog, sel))
                if t is None and not sel.group_by:
                    t = _answered("count_join",
                                  fused_join.try_run(catalog, sel))
            elif not sel.assumptions:
                # the mesh branches take the shapes the single-device
                # tiers take; a star join they decline runs gathered
                fits, t = fused_star.try_run_mesh(session, sel)
                if t is None and fits and sel.group_by:
                    t = fused_star.try_run(catalog, sel)
                if t is None and not sel.group_by:
                    t = fused_join.try_run_mesh(session, sel)
                if t is None:
                    t = dist_join_query.try_run(session, sel)
            return t if t is not None else \
                _answered("general", self._general(sel))
        if not sel.group_by and not sel.assumptions:
            if mesh is not None and one_table:
                table = placed.get(srcs[0].name)
                t = None
                if any(isinstance(p.expr, A.WindowExpr)
                       for p in sel.projections):
                    t = dist_window.try_run(session, sel, table)
                if t is None:
                    t = dist_query.run_ungrouped(session, sel, table)
                if t is None:
                    t = dist_scan.try_run(session, sel, table)
                if t is not None:
                    return t
            t = _answered("scan", fused_scan.try_run(catalog, sel))
            if t is not None:
                return t
        return _answered("general", self._general(sel))

    def _general(self, sel: A.Select) -> Table:
        ws, where = self._build_sources(sel)
        if sel.assumptions:
            ws = self._apply_assuming(ws, sel.assumptions)
        if where is not None:
            ws = self._apply_filter(ws, self._where_mask(
                EvalContext(ws, self.session), where))

        grouping = None
        key_values: list[Value] = []
        key_sentinels: list = []
        if sel.group_by:
            ctx0 = EvalContext(ws, self.session)
            key_values = [ctx0.to_row(ctx0.eval(e)) for e in sel.group_by]
            keys = []
            for v in key_values:
                # the NULL keys make one group of their own: a sentinel past
                # every value, turned back into NULL in the output
                data = v.data if isinstance(v.data, torch.Tensor) else \
                    fused_groupby._as_rows(v.data, ctx0.seg)
                sent = None
                if v.nulls is not None:
                    data, sent = _null_key_sentinel(data, v.nulls, ws.n)
                key_sentinels.append(sent)
                keys.append(_KeyCol(data, ws.n))
            grouping = gb.group_by(keys, ws.n)
            ws = ws.permuted(grouping.order, ws.n)

        ctx = EvalContext(ws, self.session, grouping)
        with span("project"):
            named = [(name, self._eval_projection(ctx, sel, expr, key_values,
                                                  key_sentinels))
                     for name, expr in self._expand_projections(sel, ws)]
        with span("finish"):
            table = self._materialize(ctx, named)
        if sel.having is not None:
            table = self._apply_having(ctx, sel, table)
        for kind, sub in sel.unions:
            table = self._combine(table, kind, self.run_select(sub))
        if sel.distinct:
            table = self._distinct_any(table)
        if sel.order_by:
            table = self._apply_order(ctx, sel, table)
        if sel.limit is not None:
            table = _limit_table(table, sel.limit)
        return table

    def _run_union(self, sel: A.Select) -> Table | None:
        """A set operation: the main branch and each arm as SELECTs of
        their own (each takes its own tier), combined left to right
        (``_combine``), deduplicated under SELECT DISTINCT; then ORDER BY
        and LIMIT over the output columns. None where an ORDER BY key is
        not an output column (the general pipeline orders by
        expressions)."""
        aliases = {(p.alias or "").lower() for p in sel.projections}
        proj_cols = {p.expr.name.lower() for p in sel.projections
                     if isinstance(p.expr, A.ColumnRef)}
        for item in sel.order_by or []:
            e = item.expr
            if not ((isinstance(e, A.ColumnRef) and e.table is None
                     and e.name.lower() in aliases | proj_cols)
                    or any(not isinstance(p.expr, A.Star) and p.expr == e
                           for p in sel.projections)):
                return None
        main = dataclasses.replace(sel, unions=[], order_by=[], limit=None,
                                   distinct=False, into_table=None,
                                   into_outfile=None)
        stats = self.session.stats
        sp0, fb0 = stats.dist_spmd, stats.dist_fallback
        table = self.run_select(main)
        for kind, sub in sel.unions:
            table = self._combine(table, kind, self.run_select(sub))
        if (self.session.mesh is not None and stats.dist_fallback == fb0
                and stats.dist_spmd > sp0):
            self.session.note_spmd()    # every arm ran over the mesh
        if sel.distinct:
            table = self._distinct_any(table)
        if sel.order_by and table.nrows:
            names = table.column_names()
            keys = []
            for item in sel.order_by:
                e = item.expr
                col = None
                if isinstance(e, A.ColumnRef) and e.table is None \
                        and e.name in table.columns:
                    col = table.columns[e.name]
                else:
                    for p, out_name in zip(sel.projections, names):
                        if (not isinstance(p.expr, A.Star) and p.expr == e) \
                                or (isinstance(e, A.ColumnRef) and p.alias
                                    and p.alias.lower() == e.name.lower()):
                            col = table.columns[out_name]
                            break
                if col is None:
                    return None
                keys.append((_sort_key_of(col, table.nrows), item.ascending))
            table = _take_table(table, sort_perm(keys, table.nrows))
        if sel.limit is not None:
            table = _limit_table(table, sel.limit)
        return table

    def _combine(self, table: Table, kind: str, other: Table) -> Table:
        """One arm of a set operation applied to the rows so far: UNION
        ALL appends, UNION appends and deduplicates, EXCEPT [ALL] and
        INTERSECT [ALL] compare row tuples (_set_op)."""
        if kind in ("all", "distinct"):
            table.append_table(other)
            return table if kind == "all" else self._distinct_any(table)
        if self.session.mesh is not None:
            t = dist_setop.try_setop(self.session, table, other, kind)
            if t is not None:
                return t
        return _set_op(table, other, kind)

    def _distinct_any(self, table: Table) -> Table:
        """DISTINCT of a materialized table: on a mesh session the tuple
        shuffle of engine/dist_setop.py, else (or where it declines)
        _distinct."""
        if self.session.mesh is not None:
            t = dist_setop.try_distinct(self.session, table)
            if t is not None:
                return t
        return _distinct(table)

    # -- sources -----------------------------------------------------------

    def _build_sources(self, sel: A.Select):
        """FROM as a WorkingSet, joined where it names several sources, and
        the WHERE conjuncts no comma-join took as keys: (ws, residual
        WHERE or None). A comma-join's keys are the WHERE equalities that
        connect it to the sources before it (the reference's joint_cols
        graph, engine/ast.py:874-1090)."""
        if not sel.sources:
            return self._empty_ws(), sel.where
        conjuncts = _split_conjuncts(sel.where)
        used = [False] * len(conjuncts)
        dev = self.session.device

        def build(src) -> WorkingSet:
            if isinstance(src, A.TableSource):
                return WorkingSet.from_table(
                    self._cat().get(src.name), dev, src.alias)
            if isinstance(src, A.SubquerySource):
                sub = self.run_select(src.select)
                if src.alias:
                    sub.name = src.alias
                return WorkingSet.from_table(sub, dev, src.alias)
            left, right = build(src.left), build(src.right)
            using = None
            if src.kind == "natural":
                using = _common_columns(left, right)
                if not using:
                    raise ExecError("NATURAL JOIN with no common columns")
            elif src.using:
                using = list(src.using)
            if using:
                pairs = [((None, k), (None, k)) for k in using]
            elif src.on is not None:
                pairs = []
                for c in _split_conjuncts(src.on):
                    pair = _equi_pair(c, left, right)
                    if pair is None:
                        raise ExecError(f"unsupported join condition {c}")
                    pairs.append(pair)
            elif src.kind == "cross":
                raise ExecError("CROSS JOIN not supported yet")
            else:
                raise ExecError("JOIN requires ON/USING")
            return self._join(left, right, pairs,
                              src.kind if src.kind in ("left", "right", "full")
                              else "inner", using)

        ws = build(sel.sources[0])
        for src in sel.sources[1:]:
            right = build(src)
            pairs = []
            for i, c in enumerate(conjuncts):
                if not used[i]:
                    pair = _equi_pair(c, ws, right)
                    if pair is not None:
                        pairs.append(pair)
                        used[i] = True
            if not pairs:
                raise ExecError(
                    "comma-join without a connecting equality in WHERE "
                    "(cartesian products not supported)")
            ws = self._join(ws, right, pairs)
        if not any(used):
            return ws, sel.where
        return ws, _join_conjuncts([c for i, c in enumerate(conjuncts)
                                    if not used[i]])

    def _join(self, left: WorkingSet, right: WorkingSet, pairs,
              kind: str = "inner", using: list[str] | None = None
              ) -> WorkingSet:
        """left ⋈ right on the column pairs: one WorkingSet over both
        sides' sources, each source's row indices composed with the
        pairs', and on an outer join's NULL side a ``missing`` mask. The
        keys of a NATURAL or USING join (``using``) are recorded for
        SELECT * to show once."""
        lkeys, rkeys = [], []
        lnulls = rnulls = None
        for (lq, lname), (rq, rname) in pairs:
            lv = left.column_value(lname, lq)
            rv = right.column_value(rname, rq)
            if (lv.sqltype.is_string and lv.dictionary is not None
                    and rv.dictionary is not None
                    and rv.dictionary is not lv.dictionary):
                with span("join.translate"):
                    rv = _translate_codes(rv, lv.dictionary)   # absent: -1
            lk, rk = lv.data, rv.data
            dt = torch.promote_types(lk.dtype, rk.dtype)
            lkeys.append(lk.to(dt))
            rkeys.append(rk.to(dt))
            if lv.nulls is not None:
                lnulls = lv.nulls if lnulls is None else lnulls | lv.nulls
            if rv.nulls is not None:
                rnulls = rv.nulls if rnulls is None else rnulls | rv.nulls
        if kind == "inner":
            li, ri, m = join_mod.equi_join(lkeys, rkeys, left.n, right.n,
                                           lnulls, rnulls)
        else:
            li, ri, m = join_mod.outer_join(lkeys, rkeys, left.n, right.n,
                                            kind, lnulls, rnulls)
        sources, indices, missing = [], [], []
        with span("join.compose"):
            for ws, idx_new, nulled in ((left, li, kind in ("right", "full")),
                                        (right, ri, kind in ("left", "full"))):
                gone = idx_new < 0 if nulled else None
                safe = idx_new.clamp(min=0)
                sources += ws.sources
                for idx, om in zip(ws.indices, ws.missing):
                    indices.append(safe if idx is None
                                   else idx[safe.clamp(max=idx.shape[0] - 1)])
                    if om is not None:
                        om = om[safe.clamp(max=om.shape[0] - 1)]
                        om = om if gone is None else om | gone
                    missing.append(gone if om is None else om)
        nl = len(left.sources)
        merged = left.merged + [(nm, lsi + nl, rsi + nl, co)
                                for nm, lsi, rsi, co in right.merged]
        for k in using or ():
            merged.append((k.lower(), left.find(k)[0],
                           right.find(k)[0] + nl, kind in ("right", "full")))
        return WorkingSet(sources, indices, m, int(li.shape[0]),
                          self.session.device, missing=missing, merged=merged)

    def _apply_assuming(self, ws: WorkingSet, assumptions) -> WorkingSet:
        """The stable sort of ASSUMING ASC/DESC columns: strings by their
        dictionary rank, NULLs before every value (as ORDER BY puts them)."""
        keys = []
        for a in assumptions:
            v = ws.column_value(a.col.name, a.col.table)
            keys.append((_order_data(v.data, v.dictionary, v.nulls),
                         a.ascending))
        return ws.permuted(sort_perm(keys, ws.n), ws.n)

    def _apply_filter(self, ws: WorkingSet, mask: torch.Tensor) -> WorkingSet:
        """The rows of mask, in order (one host sync: their count)."""
        with sync("where.compact"):
            idx, m = filter_ops.compact_indices(mask)
        cap = config.bucket_size(max(m, 1))
        return ws.permuted(torch.cat([idx, idx.new_zeros(cap - m)]), m)

    # -- projections -------------------------------------------------------

    def _expand_projections(self, sel: A.Select, ws: WorkingSet):
        out: list[tuple[str, Any]] = []
        for p in sel.projections:
            if isinstance(p.expr, A.Star):
                out.extend(ws.all_columns(p.expr.table))
            else:
                out.append((p.alias or fused_groupby.derive_name(p.expr),
                            p.expr))
        names = fused_groupby.output_names([("", None, nm) for nm, _ in out])
        return list(zip(names, (x for _, x in out)))

    def _eval_projection(self, ctx: EvalContext, sel: A.Select, expr,
                         key_values, key_sentinels) -> Value | tuple:
        if isinstance(expr, (Value, tuple)):    # resolved by SELECT *
            return expr
        if ctx.grouping is not None:
            ki = _match_group_key(expr, sel.group_by)
            if ki is not None:
                kv = key_values[ki]
                data = ctx.grouping.key_values[ki]
                nulls = None
                sent = key_sentinels[ki]
                if sent is not None:            # the NULL group's key
                    nulls = data == sent
                    data = torch.where(nulls, torch.zeros_like(data), data)
                return Value("group", data, kv.sqltype, kv.dictionary,
                             nulls=nulls)
        return ctx.eval(expr)

    def _materialize(self, ctx: EvalContext, named) -> Table:
        grouped = ctx.grouping is not None
        if grouped:
            nrows = ctx.G
        elif any(isinstance(v, tuple) or v.kind == "row" for _, v in named):
            nrows = ctx.ws.n
        else:
            nrows = 1 if named else 0
        return Table(f"result_{base62uuid(4)}",
                     [self._materialize_one(ctx, name, v, nrows)
                      for name, v in named])

    def _materialize_one(self, ctx: EvalContext, name: str, v, nrows: int):
        ws = ctx.ws
        if isinstance(v, tuple):                # a vector column from *
            si, vcol = v
            idx = ws.indices[si]
            if idx is None:
                return vcol.with_name(name)
            return _take_vector(vcol, idx[:ws.n], name)

        if v.pack_cols is not None:
            k = len(v.pack_cols)
            n = ws.n
            flat = torch.stack([c[:ws.capacity] for c in v.pack_cols],
                               dim=1).reshape(-1)[:n * k]
            offsets = torch.arange(n + 1, dtype=torch.int64,
                                   device=ws.device) * k
            return VectorColumn(name, v.sqltype, flat, offsets, nrows=n,
                                total=n * k)

        dev = ws.device
        if v.kind == "scalar" and v.sqltype.is_vector:   # a module's vector
            return VectorColumn.from_lists(name, v.sqltype, [v.data] * nrows,
                                           device=dev)
        if v.kind == "scalar":
            if isinstance(v.data, str):
                d = StringDict([v.data])
                return Column(name, T.StrT, torch.zeros(nrows, dtype=torch.int32,
                                                        device=dev),
                              nrows=nrows, dictionary=d)
            dt = T.torch_dtype(v.sqltype.np_dtype)
            if v.data is None:                  # a NULL literal
                return Column(name, v.sqltype, torch.zeros(nrows, dtype=dt,
                                                           device=dev),
                              nrows=nrows, valid=torch.zeros(
                                  nrows, dtype=torch.bool, device=dev))
            data = torch.as_tensor(v.data, dtype=dt, device=dev).reshape(1)
            valid = None
            if v.nulls is not None:
                valid = (~torch.as_tensor(v.nulls, device=dev)).reshape(1) \
                    .expand(nrows)
            return Column(name, v.sqltype, data.expand(nrows), nrows=nrows,
                          valid=valid)

        if v.kind == "group":
            if ctx.grouping is None:            # one group: broadcast its value
                return Column(name, v.sqltype, v.data[:1].expand(nrows),
                              nrows=nrows, dictionary=v.dictionary,
                              valid=None if v.nulls is None
                              else (~v.nulls[:1]).expand(nrows))
            return Column(name, v.sqltype, v.data[:ctx.G], nrows=ctx.G,
                          dictionary=v.dictionary,
                          valid=None if v.nulls is None else ~v.nulls[:ctx.G])

        valid_rows = torch.arange(ws.capacity, device=dev) < ws.n
        if ctx.grouping is None:                # one value per row
            if v.mask is not None:
                idx, m = filter_ops.compact_indices(v.mask & valid_rows)
                return Column(name, v.sqltype, v.data[idx], nrows=m,
                              dictionary=v.dictionary,
                              valid=None if v.nulls is None else ~v.nulls[idx])
            return Column(name, v.sqltype, v.data[:ws.n], nrows=ws.n,
                          dictionary=v.dictionary,
                          valid=None if v.nulls is None else ~v.nulls[:ws.n])

        # grouped: one vector per group of the group's (kept) rows
        if v.mask is None:
            offsets = ctx.grouping.offsets[:ctx.G + 1]
            return VectorColumn(name, T.VectorT(v.sqltype), v.data[:ws.n],
                                offsets, nrows=ctx.G,
                                dictionary=v.dictionary, total=ws.n)
        mask = v.mask & valid_rows
        idx, m = filter_ops.compact_indices(mask)
        counts = grouped_agg.compute(ctx, "count", [v])
        offsets = torch.cat([counts.data.new_zeros(1),
                             torch.cumsum(counts.data[:ctx.G], 0)])
        return VectorColumn(name, T.VectorT(v.sqltype), v.data[idx], offsets,
                            nrows=ctx.G, dictionary=v.dictionary, total=m)

    # -- post-processing ---------------------------------------------------

    def _apply_having(self, ctx: EvalContext, sel: A.Select,
                      table: Table) -> Table:
        hv = ctx.eval(sel.having)
        if hv.kind != "group":
            raise ExecError("HAVING must be a per-group predicate")
        keep = _bool_rows(hv.data, ctx.ws)[:table.nrows]
        if hv.nulls is not None:
            keep = keep & ~hv.nulls[:table.nrows]
        return _take_table(table, filter_ops.compact_indices(keep)[0])

    def _apply_order(self, ctx: EvalContext, sel: A.Select,
                     table: Table) -> Table:
        n = table.nrows
        if n == 0:
            return table
        keys = [(self._order_key(ctx, sel, table, item.expr), item.ascending)
                for item in sel.order_by]
        return _take_table(table, sort_perm(keys, n))

    def _order_key(self, ctx: EvalContext, sel: A.Select, table: Table,
                   expr) -> torch.Tensor:
        """[n] sort key of an ORDER BY item: an output column (by name or
        by the projection it equals), else the expression evaluated per
        output row (a grouped row expression at each group's first row)."""
        n = table.nrows
        if isinstance(expr, A.ColumnRef) and expr.table is None \
                and expr.name in table.columns:
            return _sort_key_of(table.columns[expr.name], n)
        for p, out_name in zip(sel.projections, table.column_names()):
            if not isinstance(p.expr, A.Star) and p.expr == expr:
                return _sort_key_of(table.columns[out_name], n)
        v = ctx.eval(expr)
        if v.kind == "scalar":
            return torch.zeros(n, device=ctx.ws.device)
        if v.kind == "row" and ctx.grouping is not None:
            v = grouped_agg.compute(ctx, "first", [v])
        return _order_data(v.data[:n], v.dictionary,
                           None if v.nulls is None else v.nulls[:n])


# --------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------- #

def _answered(tier: str, table: Table | None) -> Table | None:
    """table, counted in the session's ``tier_runs`` under tier where a
    tier gave one."""
    if table is not None:
        note_tier(tier)
    return table


def _position(e: A.Expr) -> int | None:
    """n where e is a bare integer literal (a positional ORDER BY or
    GROUP BY item), else None: ``1 + 0`` stays a constant expression."""
    if isinstance(e, A.Literal) and not e.is_string and type(e.value) is int:
        return e.value
    return None


def _has_aggregate(e, udfs) -> bool:
    """Whether expression e calls an aggregate or an AGGREGATION
    FUNCTION outside a subquery."""
    if isinstance(e, A.Subquery):
        return False
    if isinstance(e, A.Call):
        name = e.func.lower()
        if name in AGG_NAMES or (name in udfs
                                 and udfs[name].is_aggregation):
            return True
    if dataclasses.is_dataclass(e):
        return any(_has_aggregate(getattr(e, f.name), udfs)
                   for f in dataclasses.fields(e))
    if isinstance(e, (list, tuple)):
        return any(_has_aggregate(x, udfs) for x in e)
    return False


def _resolve_positions(sel: A.Select, udfs) -> A.Select:
    """sel with each positional item resolved (SQL-92, and MonetDB, which
    runs the reference's SQL part): ``ORDER BY n`` sorts by the n-th
    output column, i.e. by the n-th projection's expression, which every
    tier matches to its output column; ``GROUP BY n`` groups by the n-th
    projection's expression. Raises ExecError where n is out of range, a
    ``*`` comes at or before n, or GROUP BY's n-th item is an aggregate
    or itself an integer literal. An ORDER BY item that resolves to a
    literal sorts by a constant and is dropped, so that a resolved
    statement run again (a set operation's main branch) resolves to
    itself."""
    if not any(_position(e) is not None for e in sel.group_by) and \
            not any(_position(o.expr) is not None for o in sel.order_by):
        return sel

    def item(n: int, clause: str) -> A.Expr:
        if not 1 <= n <= len(sel.projections):
            raise ExecError(f"{clause} {n} is out of range: the select "
                            f"list has {len(sel.projections)} item(s)")
        if any(isinstance(p.expr, A.Star) for p in sel.projections[:n]):
            raise ExecError(f"{clause} {n}: the select list has a * at "
                            f"or before item {n}")
        return sel.projections[n - 1].expr

    group_by = []
    for e in sel.group_by:
        n = _position(e)
        if n is not None:
            e = item(n, "GROUP BY")
            if _has_aggregate(e, udfs):
                raise ExecError(f"GROUP BY {n}: select item {n} is an "
                                f"aggregate")
            if _position(e) is not None:
                raise ExecError(f"GROUP BY {n}: select item {n} is an "
                                f"integer literal")
        group_by.append(e)
    order_by = []
    for o in sel.order_by:
        n = _position(o.expr)
        if n is not None:
            e = item(n, "ORDER BY")
            if isinstance(e, A.Literal):
                continue
            o = A.OrderItem(e, o.ascending)
        order_by.append(o)
    return dataclasses.replace(sel, group_by=group_by, order_by=order_by)


def _distinct_to_groupby(sel: A.Select, catalog) -> A.Select | None:
    """SELECT DISTINCT e1, …, ek → SELECT e1, …, ek GROUP BY e1, …, ek when
    every projection is a plain row expression (columns, literals,
    operators, math calls) over catalog tables with no vector column
    among those referenced, and no projection is a bare literal; None
    otherwise. Groups come out key-ascending, as a DISTINCT sorts."""
    if (not sel.distinct or sel.group_by or sel.unions
            or sel.having is not None or sel.assumptions or not sel.sources):
        return None

    def plain(e) -> bool:
        if isinstance(e, (A.ColumnRef, A.Literal)):
            return True
        if isinstance(e, A.BinOp):
            return plain(e.left) and plain(e.right)
        if isinstance(e, A.UnaryOp):
            return plain(e.operand)
        if isinstance(e, A.Call):
            return e.func in fused_groupby._MATH and all(plain(a)
                                                         for a in e.args)
        return False

    if not sel.projections or any(isinstance(p.expr, (A.Star, A.Literal))
                                  or not plain(p.expr)
                                  for p in sel.projections):
        return None

    def leaves(src):
        if isinstance(src, A.TableSource):
            yield src
        elif isinstance(src, A.JoinSource):
            yield from leaves(src.left)
            yield from leaves(src.right)
        else:
            yield None

    refs: set[str] = set()
    for p in sel.projections:
        refs |= fused_groupby._refs(p.expr)
    for src in sel.sources:
        for leaf in leaves(src):
            if leaf is None or leaf.name not in catalog:
                return None
            t = catalog.get(leaf.name)
            if any(nm in t.columns and t.columns[nm].is_vector
                   for nm in refs):
                return None
    group_by: list[A.Expr] = []
    for p in sel.projections:
        if not any(p.expr == g for g in group_by):
            group_by.append(p.expr)
    return dataclasses.replace(sel, distinct=False, group_by=group_by)


def _split_conjuncts(e: A.Expr | None) -> list[A.Expr]:
    if e is None:
        return []
    if isinstance(e, A.BinOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _join_conjuncts(cs: list[A.Expr]) -> A.Expr | None:
    out = None
    for c in cs:
        out = c if out is None else A.BinOp("and", out, c)
    return out


def _equi_pair(c: A.Expr, left: WorkingSet, right: WorkingSet):
    """((lq, lname), (rq, rname)) where c is ``lcol = rcol`` linking left
    to right, else None. A qualified name pins its side; an unqualified
    one must resolve on one side only."""
    if not (isinstance(c, A.BinOp) and c.op == "="
            and isinstance(c.left, A.ColumnRef)
            and isinstance(c.right, A.ColumnRef)):
        return None
    a, b = c.left, c.right
    a_l, a_r = left.has_column(a.name, a.table), right.has_column(a.name,
                                                                  a.table)
    b_l, b_r = left.has_column(b.name, b.table), right.has_column(b.name,
                                                                  b.table)
    if a_l and b_r and not (a_r and b_l):
        return (a.table, a.name), (b.table, b.name)
    if b_l and a_r and not (b_r and a_l):
        return (b.table, b.name), (a.table, a.name)
    if a_l and b_r:
        return (a.table, a.name), (b.table, b.name)
    return None


def _common_columns(left: WorkingSet, right: WorkingSet) -> list[str]:
    """NATURAL JOIN's keys: right's column names that left also has."""
    lnames = {c.lower() for _, t in left.sources for c in t.column_names()}
    return [c for _, t in right.sources for c in t.column_names()
            if c.lower() in lnames]


def _distinct(table: Table) -> Table:
    """The distinct rows of a materialized table, key-ascending (string
    columns by code), as the JAX package's _distinct orders them:
    engine/groupby over every column, a NULL coded as a sentinel past the
    column's values so that NULLs are one value."""
    n = table.nrows
    if n == 0:
        return table
    cols = list(table.columns.values())
    if any(c.is_vector for c in cols):
        raise ExecError("DISTINCT over vector columns not supported")
    keys, sents = [], []
    for c in cols:
        data, sent = c.data, None
        if c.valid is not None:
            data, sent = _null_key_sentinel(data, ~c.valid, n)
        sents.append(sent)
        keys.append(_KeyCol(data, n))
    grouping = gb.group_by(keys, n)
    g = grouping.num_groups
    out = Table(table.name)
    for c, kv, sent in zip(cols, grouping.key_values, sents):
        kv = kv[:g]
        valid = None
        if sent is not None:
            valid = kv != sent
            kv = torch.where(valid, kv, torch.zeros_like(kv))
        out.add_column(Column(c.name, c.sqltype, kv.to(c.data.dtype),
                              nrows=g, dictionary=c.dictionary, valid=valid))
    return out


def _set_op(left: Table, right: Table, kind: str) -> Table:
    """EXCEPT [ALL] or INTERSECT [ALL] of two materialized tables on the
    device, in left-input order (the JAX package's row-tuple algebra,
    which decodes both to the host).

    Both arms' rows, the right's first, sort stably by their tuples (NULL
    equals NULL, -0.0 equals 0.0, NaN equals NaN; the right arm's strings
    in the left arm's codes, -1 where the left lacks one). In each run of
    equal tuples the right rows then come first and the left rows follow
    in their order, so one segmented int64 scan (seg_cumsum_i64) of the
    side flags, left in the low 32 bits and right in the high, gives each
    left row its rank among the run's left rows and the run's right
    count. EXCEPT keeps rank 0 with no right row, INTERSECT rank 0 with
    one; EXCEPT ALL keeps rank ≥ the right count (the first that many
    occurrences cancel), INTERSECT ALL rank < it. One sort of the kept
    indices restores left order; the host reads their count."""
    lcols, rcols = list(left.columns.values()), list(right.columns.values())
    if len(lcols) != len(rcols):
        raise ExecError("set operation requires equal column counts")
    if any(c.is_vector for c in lcols + rcols):
        raise ExecError("set operations over vector columns not supported")
    n1, n2 = left.nrows, right.nrows
    if n1 == 0:
        return left
    n = n1 + n2
    cap = config.bucket_size(n)
    dev = lcols[0].device

    keys = []
    for lc, rc in zip(lcols, rcols):
        r = rc.data
        if (lc.sqltype.is_string and lc.dictionary is not None
                and rc.dictionary is not None
                and rc.dictionary is not lc.dictionary):
            r = _translate_codes(Value("row", r, rc.sqltype, rc.dictionary),
                                 lc.dictionary).data
        dt = torch.promote_types(lc.data.dtype, r.dtype)
        x = torch.cat([r[:n2].to(dt), lc.data[:n1].to(dt)])
        if lc.valid is not None or rc.valid is not None:
            def null(c, k):
                return (torch.zeros(k, dtype=torch.bool, device=dev)
                        if c.valid is None else ~c.valid[:k])
            nulls = torch.cat([null(rc, n2), null(lc, n1)])
            x = torch.where(nulls, torch.zeros((), dtype=dt, device=dev), x)
            keys.append((_padded(nulls, cap), True))
        keys.append((_padded(x, cap), True))
    valid = torch.arange(cap, device=dev) < n
    perm, valid_s, _sk, starts, _last = fused_groupby.sorted_groups(valid,
                                                                    keys)
    is_left = valid_s & (perm >= n2)
    is_right = valid_s & (perm < n2)
    both = S.seg_cumsum(is_left.to(torch.int64)
                        | (is_right.to(torch.int64) << 32), starts)
    rank = (both & 0xFFFFFFFF) - 1
    rcount = both >> 32
    if kind == "except":
        keep = (rank == 0) & (rcount == 0)
    elif kind == "intersect":
        keep = (rank == 0) & (rcount > 0)
    elif kind == "except_all":
        keep = rank >= rcount
    else:
        keep = rank < rcount
    idx, _m = filter_ops.compact_indices(keep & is_left)
    return _take_table(left, torch.sort(perm[idx] - n2)[0])


def _padded(x: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(cap - x.shape[0])])


class _KeyCol:
    """A computed key tensor with lazy (min, max) stats of its first n
    rows, as engine/groupby.group_by reads them (one host sync)."""

    def __init__(self, data: torch.Tensor, n: int) -> None:
        self.data = data.to(torch.int32) if data.dtype == torch.bool else data
        self.n = n
        self._stats = None

    def stats(self):
        if self._stats is None:
            d = self.data
            valid = torch.arange(d.shape[0], device=d.device) < self.n
            both = torch.stack([
                torch.where(valid, d, torch.full((), big_of(d.dtype),
                                                 dtype=d.dtype,
                                                 device=d.device)).min(),
                torch.where(valid, d, torch.full((), small_of(d.dtype),
                                                 dtype=d.dtype,
                                                 device=d.device)).max()])
            lo, hi = both.tolist()
            self._stats = (lo, hi)
        return self._stats


def _bool_rows(data, ws: WorkingSet) -> torch.Tensor:
    """A predicate's values as a [capacity] bool tensor."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(bool(data), device=ws.device)
    if data.dtype != torch.bool:
        data = data != 0
    return data.expand(ws.capacity) if data.dim() == 0 else data


def _match_group_key(expr: A.Expr, group_by) -> int | None:
    for i, g in enumerate(group_by):
        if expr == g or (isinstance(expr, A.ColumnRef)
                         and isinstance(g, A.ColumnRef)
                         and expr.name.lower() == g.name.lower()):
            return i
    return None


def _null_key_sentinel(data: torch.Tensor, nulls: torch.Tensor, n: int):
    """NULL key rows replaced by a sentinel past the non-NULL maximum (+inf
    for floats), so the NULLs make one group, last: (data', sentinel)."""
    if data.is_floating_point():
        return torch.where(nulls, float("inf"), data), float("inf")
    ok = (torch.arange(data.shape[0], device=data.device) < n) & ~nulls
    d64 = data.to(torch.int64)
    mx = int(torch.where(ok, d64, torch.iinfo(torch.int64).min).max())
    sent = max(mx, -2**62) + 1
    wide = torch.where(nulls, sent, d64)
    if data.dtype != torch.bool and sent <= torch.iinfo(data.dtype).max:
        return wide.to(data.dtype), sent
    return wide, sent


def _order_data(data: torch.Tensor, dictionary, nulls) -> torch.Tensor:
    """A sort key: string codes as lexicographic ranks, NULLs as the
    dtype's minimum (first ascending, as MonetDB orders them)."""
    if dictionary is not None and len(dictionary):
        ranks = torch.from_numpy(dictionary.ranks).to(data.device)
        data = ranks[data.clamp(0, len(ranks) - 1).long()]
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    if nulls is not None:
        small = float("-inf") if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        data = torch.where(nulls, small, data)
    return data


def _sort_key_of(col, n: int) -> torch.Tensor:
    """An output column's sort key over its n rows (a vector column by
    each row's first element, 0 when empty)."""
    if col.is_vector:
        lens = col.offsets[1:n + 1] - col.offsets[:n]
        first = col.values[col.offsets[:n].clamp(0, col.values.shape[0] - 1)]
        return torch.where(lens > 0, first, torch.zeros_like(first))
    return _order_data(col.data[:n],
                       col.dictionary if col.sqltype.is_string else None,
                       None if col.valid is None else ~col.valid[:n])


def _take_vector(vcol: VectorColumn, idx: torch.Tensor,
                 name: str) -> VectorColumn:
    """The rows idx of a vector column (one host sync: their value
    count)."""
    k = int(idx.shape[0])
    if k == 0:
        return VectorColumn(name, vcol.sqltype, vcol.values[:0],
                            vcol.offsets[:1] * 0, nrows=0,
                            dictionary=vcol.dictionary, total=0)
    total = int(ragged.lengths_from_offsets(vcol.offsets)[idx].sum())
    vals, offs = ragged.take(vcol.values, vcol.offsets, idx, k,
                             config.bucket_size(max(total, 1)), total)
    return VectorColumn(name, vcol.sqltype, vals, offs[:k + 1], nrows=k,
                        dictionary=vcol.dictionary, total=total)


def _take_table(table: Table, idx: torch.Tensor) -> Table:
    """The rows idx (an int64 tensor) of every column, in that order."""
    k = int(idx.shape[0])
    out = Table(table.name)
    for c in table.columns.values():
        if c.is_vector:
            out.add_column(_take_vector(c, idx, c.name))
        else:
            out.add_column(Column(c.name, c.sqltype, c.data[idx], nrows=k,
                                  dictionary=c.dictionary,
                                  valid=None if c.valid is None
                                  else c.valid[idx]))
    return out


def _limit_table(table: Table, k: int) -> Table:
    n = min(table.nrows, k)
    if n == table.nrows:
        return table
    dev = next(iter(table.columns.values())).device
    return _take_table(table, torch.arange(n, device=dev))


# --------------------------------------------------------------------- #
# mesh sessions
# --------------------------------------------------------------------- #

class _All(Exception):
    pass


def _statement_columns(stmt) -> set[str] | None:
    """Lower-cased names of every column a SELECT (or CREATE TABLE AS)
    names, subqueries included; None (every column) where it needs them
    all: a star, a NATURAL join, any other statement."""
    if isinstance(stmt, A.CreateTable) and stmt.as_select is not None:
        stmt = stmt.as_select
    if not isinstance(stmt, A.Select):
        return None
    names: set[str] = set()

    def walk(x):
        if isinstance(x, A.Star) or (isinstance(x, A.JoinSource)
                                     and x.kind == "natural"):
            raise _All
        if isinstance(x, A.ColumnRef):
            names.add(x.name.lower())
        elif isinstance(x, A.JoinSource):
            names.update(u.lower() for u in x.using or ())
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)

    try:
        walk(stmt)
    except _All:
        return None
    return names


class _GatheredCatalog:
    """One mesh statement's catalog for single-device code: a placed
    table comes back gathered whole (the columns the statement names),
    once per statement; any other table as it is."""

    def __init__(self, session, names: set[str] | None) -> None:
        self.session = session
        self.catalog = session.catalog
        self.wanted = names
        self.cache: dict[str, Table] = {}

    def get(self, name: str) -> Table:
        key = name.lower()
        if key not in self.cache:
            self.cache[key] = self.session.readable(self.catalog.get(name),
                                                    self.wanted)
        return self.cache[key]

    def forget(self, name: str) -> None:
        self.cache.pop(name.lower(), None)

    def __contains__(self, name: str) -> bool:
        return name in self.catalog

    def create(self, table: Table, replace: bool = False) -> Table:
        self.forget(table.name)
        return self.catalog.create(table, replace=replace)

    def drop(self, name: str, if_exists: bool = False) -> None:
        self.forget(name)
        self.catalog.drop(name, if_exists=if_exists)

    def names(self) -> list[str]:
        return self.catalog.names()
