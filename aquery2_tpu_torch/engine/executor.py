"""Statement executor: CREATE TABLE, INSERT … VALUES, grouped SELECT and
the fused joins.

Counterpart of ``aquery2_tpu/engine/executor.py``, reduced to DDL, literal
inserts and the single-device fused branches of a SELECT, tried in the
JAX package's order:
  - one table, grouped: the fused group-by (engine/fused_groupby.py), and
    where its plan does not cover the statement, the ordered group-by with
    running and windowed aggregates, ASSUMING and subvec
    (engine/fused_ordered.py);
  - two tables (comma-separated, or one NATURAL, ON or USING join), no
    ASSUMING: the star join into the fused group-by
    (engine/fused_star.py), then, without GROUP BY, the count join
    (engine/fused_join.py).
A join neither takes (duplicate dim keys, nullable join tables, string
keys in different dictionaries, three tables, any other aggregate) raises
NotImplementedError naming the general join's ROADMAP items; every other
statement raises it naming the ROADMAP item that brings it.
"""

from __future__ import annotations

from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import (fused_groupby, fused_join,
                                      fused_ordered, fused_star)
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.result import Result
from aquery2_tpu_torch.storage.table import Column, StringDict, Table

_GENERAL = "ROADMAP queue 1, item 7 (general engine)"
_JOIN = "ROADMAP queue 1, items 6b and 7 (general join)"


class Executor:
    def __init__(self, session) -> None:
        self.session = session

    def execute(self, stmt: A.Statement) -> Result | None:
        if isinstance(stmt, A.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, A.Insert):
            return self._insert(stmt)
        if isinstance(stmt, A.Select):
            return Result(self._run_select(stmt))
        raise NotImplementedError(f"{type(stmt).__name__}: {_GENERAL}")

    def _create_table(self, stmt: A.CreateTable) -> None:
        if stmt.as_select is not None:
            raise NotImplementedError(f"CREATE TABLE AS SELECT: {_GENERAL}")
        dev = self.session.device
        cols = []
        for cd in stmt.columns:
            t = T.from_sql_name(cd.type_name)
            cols.append(Column.from_host(
                cd.name, t, [], device=dev,
                dictionary=StringDict() if t.is_string else None))
        self.session.catalog.create(Table(stmt.name, cols))
        return None

    def _insert(self, stmt: A.Insert) -> None:
        tbl = self.session.catalog.get(stmt.table)
        if stmt.select is not None:
            raise NotImplementedError(f"INSERT … SELECT: {_GENERAL}")
        rows = []
        for row in stmt.values:
            vals = []
            for e in row:
                if isinstance(e, A.Literal):
                    vals.append(e.value)
                elif (isinstance(e, A.UnaryOp) and e.op == "-"
                        and isinstance(e.operand, A.Literal)):
                    vals.append(-e.operand.value)
                else:
                    raise NotImplementedError(
                        f"INSERT of a computed value: {_GENERAL}")
            rows.append(vals)
        if stmt.columns:
            order = [c.lower() for c in stmt.columns]
            names = [c.lower() for c in tbl.column_names()]
            if set(order) != set(names):
                raise ValueError("INSERT column list must cover all columns")
            perm = [order.index(nm) for nm in names]
            rows = [[r[i] for i in perm] for r in rows]
        tbl.append_rows(rows)
        return None

    def _run_select(self, sel: A.Select) -> Table:
        catalog = self.session.catalog
        srcs = sel.sources
        if len(srcs) > 1 or any(isinstance(s, A.JoinSource) for s in srcs):
            t = None
            if not sel.assumptions:
                t = fused_star.try_run(catalog, sel)
                if t is None and not sel.group_by:
                    t = fused_join.try_run(catalog, sel)
            if t is not None:
                return t
            raise NotImplementedError(
                f"join outside the star and count-join paths: {_JOIN}")
        if (sel.group_by and len(srcs) == 1
                and isinstance(srcs[0], A.TableSource)
                and srcs[0].name in catalog):
            table = catalog.get(srcs[0].name)
            t = fused_groupby.run(sel, table)
            if t is None:
                t = fused_ordered.run(sel, table)
            if t is not None:
                return t
        raise NotImplementedError(
            f"SELECT outside the fused group-by and ordered paths: "
            f"{_GENERAL}")
