"""SQL backends that execute queries (the reference's DataSource vtable).

Counterpart of ``aquery2_tpu/storage/datasource.py`` (the reference's
``DataSource`` backends, server/DataSource_conn.h:27-54, and the
append-back of result tables, table_ext_monetdb.hpp:34-86). The device
store is the primary database; an attached source is a peer SQL engine
that a session can

  * ``exec`` SQL on (a statement that returns rows comes back as a table
    on the session's device, ``into`` the catalog),
  * ``get_table`` from (one backend table read into the device store),
  * ``append_table`` to (a device table written out: CREATE TABLE IF NOT
    EXISTS from its schema, then its rows).

Backends: SQLite (stdlib) and any DB-API 2.0 connection. Sessions hold
them by alias (``Session.attach``/``detach``/``backend_exec``/
``backend_append``); the REPL's ``attach``, ``detach``, ``backend`` and
``export`` commands call those.
"""

from __future__ import annotations

import sqlite3
from typing import Any

from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.storage.external import (_infer_schema, import_cursor,
                                                rows_to_table)
from aquery2_tpu_torch.storage.table import Table


class DataSourceError(Exception):
    pass


class DataSource:
    """A query-executing backend (reference DataSource_conn.h:27-54)."""

    backend_type = "AQuery"     # the reference's Backend_Type name

    def __init__(self) -> None:
        self.last_error: str | None = None

    def exec(self, sql: str, session=None,
             into: str | None = None) -> Table | None:
        """Run SQL on the backend: a statement that returns rows gives a
        Table (in the session's catalog as ``into``, where a session is
        given), any other None."""
        raise NotImplementedError

    def get_table(self, name: str, session=None,
                  target: str | None = None) -> Table:
        """Read one backend table into the device store (getDSTable)."""
        return self.exec(f"SELECT * FROM {name}", session,
                         into=target or name)

    def append_table(self, table: Table, alt_name: str | None = None,
                     create: bool = True) -> None:
        """Write a device table into the backend."""
        raise NotImplementedError

    def haserror(self) -> bool:
        return self.last_error is not None

    def close(self) -> None:
        pass

    @staticmethod
    def _sql_decl(t: T.SQLType) -> str:
        if t.is_string:
            return "TEXT"
        if t.kind == "float":
            return "REAL"
        if t.kind == "bool":
            return "BOOLEAN"
        return "INTEGER"

    def _create_stmt(self, table: Table, name: str) -> str:
        cols = ", ".join(f"{c.name} {self._sql_decl(c.sqltype)}"
                         for c in table.columns.values() if not c.is_vector)
        return f"CREATE TABLE IF NOT EXISTS {name} ({cols})"

    @staticmethod
    def _rows_of(table: Table) -> list[tuple]:
        pys = [c.to_python() for c in table.columns.values()
               if not c.is_vector]
        return list(zip(*pys)) if pys else []


class DBAPISource(DataSource):
    """Any DB-API 2.0 connection as a backend."""

    backend_type = "DBAPI"

    def __init__(self, conn: Any, paramstyle: str = "qmark") -> None:
        super().__init__()
        self.conn = conn
        self.placeholder = "?" if paramstyle == "qmark" else "%s"

    def exec(self, sql: str, session=None,
             into: str | None = None) -> Table | None:
        self.last_error = None
        try:
            cur = self.conn.cursor()
            cur.execute(sql)
            if cur.description is None:
                if hasattr(self.conn, "commit"):
                    self.conn.commit()
                return None
            name = into or "backend_result"
            if session is not None:
                return import_cursor(session, name, cur)
            rows = cur.fetchall()
            return rows_to_table(name, rows, _infer_schema(cur, rows), "cpu")
        except Exception as e:          # noqa: BLE001 — haserror's state
            self.last_error = str(e)
            raise DataSourceError(str(e)) from e

    def append_table(self, table: Table, alt_name: str | None = None,
                     create: bool = True) -> None:
        name = alt_name or table.name
        cur = self.conn.cursor()
        if create:
            cur.execute(self._create_stmt(table, name))
        rows = self._rows_of(table)
        if rows:
            ph = ", ".join([self.placeholder] * len(rows[0]))
            cur.executemany(f"INSERT INTO {name} VALUES ({ph})", rows)
        if hasattr(self.conn, "commit"):
            self.conn.commit()

    def close(self) -> None:
        self.conn.close()


class SQLiteSource(DBAPISource):
    """An embedded SQLite database (the stand-in for the reference's
    embedded MonetDB). One connection, usable from any thread."""

    backend_type = "SQLite"

    def __init__(self, path: str = ":memory:") -> None:
        super().__init__(sqlite3.connect(path, check_same_thread=False))
        self.path = path


def open_source(spec: str) -> DataSource:
    """'sqlite:<path>', a file path or ':memory:' → a SQLiteSource."""
    if spec.startswith("sqlite:"):
        return SQLiteSource(spec[len("sqlite:"):])
    return SQLiteSource(spec)
