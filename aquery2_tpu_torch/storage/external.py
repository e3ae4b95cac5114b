"""External data in: SQLite databases, DB-API cursors, pandas DataFrames.

Counterpart of ``aquery2_tpu/storage/external.py`` (the reference's
DataSource backends, server/DataSource_conn.h:27-54). The device store
is the database; an external source is read once into tables on the
session's device:

  * ``attach_sqlite``: tables of a SQLite file (stdlib sqlite3), typed by
    their declared column types;
  * ``import_cursor``: the result set of any DB-API 2.0 cursor;
  * ``from_dataframe`` / ``to_dataframe``: pandas (imported by pandas'
    caller, or in ``Result.to_pandas``: the port does not need it).

A NULL becomes 0 with validity False; strings are coded into a new
dictionary in the order they first appear, as the JAX package codes them.
"""

from __future__ import annotations

import sqlite3
from typing import Any, Iterable

import numpy as np

from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.storage.table import Column, StringDict, Table

_SQLITE_TYPES = {
    "INTEGER": T.LongT, "INT": T.IntT, "BIGINT": T.LongT,
    "SMALLINT": T.ShortT, "TINYINT": T.ByteT,
    "REAL": T.DoubleT, "FLOAT": T.FloatT, "DOUBLE": T.DoubleT,
    "TEXT": T.StrT, "VARCHAR": T.StrT, "CHAR": T.StrT,
    "DATE": T.DateT, "TIMESTAMP": T.TimestampT, "BOOLEAN": T.BoolT,
}


def _sqlite_type(decl: str | None) -> T.SQLType:
    if not decl:
        return T.DoubleT
    return _SQLITE_TYPES.get(decl.split("(")[0].strip().upper(), T.StrT)


def attach_sqlite(session, path: str, tables: Iterable[str] | None = None,
                  prefix: str = "") -> list[str]:
    """Read tables of a SQLite database (all, or ``tables``) into the
    session's catalog as ``prefix + name``; their names."""
    conn = sqlite3.connect(session.resolve_path(path))
    try:
        if tables is None:
            tables = [r[0] for r in conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table'")]
        out = []
        for tname in tables:
            info = conn.execute(f"PRAGMA table_info({tname})").fetchall()
            schema = [(r[1], _sqlite_type(r[2])) for r in info]
            import_cursor(session, prefix + tname,
                          conn.execute(f"SELECT * FROM {tname}"), schema)
            out.append(prefix + tname)
        return out
    finally:
        conn.close()


def _infer_schema(cursor, rows) -> list[tuple[str, T.SQLType]]:
    """Each column's type from its first non-NULL value: int → BIGINT,
    float → DOUBLE, anything else → VARCHAR."""
    schema = []
    for j, d in enumerate(cursor.description):
        sample = next((r[j] for r in rows if r[j] is not None), None)
        if isinstance(sample, (int, np.integer)):
            schema.append((d[0], T.LongT))
        elif isinstance(sample, (float, np.floating)):
            schema.append((d[0], T.DoubleT))
        else:
            schema.append((d[0], T.StrT))
    return schema


def rows_to_table(name: str, rows, schema, device) -> Table:
    """Host rows (tuples, None for NULL) as a Table of ``schema`` on
    ``device``."""
    cols = []
    for j, (nm, t) in enumerate(schema):
        vals = [r[j] for r in rows]
        valid = None
        if any(v is None for v in vals):
            valid = np.asarray([v is not None for v in vals])
        if t.is_string:
            d = StringDict()
            codes = d.encode(["" if v is None else str(v) for v in vals])
            cols.append(Column(nm, t, codes, dictionary=d, valid=valid,
                               device=device))
            continue
        if t.is_temporal:
            vals = [T.parse_temporal_literal(t, v) if isinstance(v, str)
                    else v for v in vals]
        arr = np.asarray([0 if v is None else v for v in vals],
                         dtype=t.np_dtype)
        cols.append(Column(nm, t, arr, valid=valid, device=device))
    return Table(name, cols)


def import_cursor(session, table_name: str, cursor: Any,
                  schema: list[tuple[str, T.SQLType]] | None = None) -> Table:
    """A DB-API cursor's result set as a table of the session's catalog
    (replacing one of that name), on the session's device."""
    rows = cursor.fetchall()
    if schema is None:
        schema = _infer_schema(cursor, rows)
    tbl = rows_to_table(table_name, rows, schema, session.device)
    session.catalog.create(tbl, replace=True)
    return tbl


def from_dataframe(session, table_name: str, df: Any) -> Table:
    """A pandas DataFrame as a table of the session's catalog."""
    cols = []
    for name in df.columns:
        s = df[name]
        kind = s.dtype.kind
        if kind in "iu":
            t = T.LongT if s.dtype.itemsize > 4 else T.IntT
        elif kind == "f":
            t = T.DoubleT if s.dtype.itemsize > 4 else T.FloatT
        elif kind == "b":
            t = T.BoolT
        else:
            d = StringDict()
            cols.append(Column(str(name), T.StrT,
                               d.encode([str(v) for v in s.tolist()]),
                               dictionary=d, device=session.device))
            continue
        cols.append(Column(str(name), t, s.to_numpy().astype(t.np_dtype),
                           device=session.device))
    tbl = Table(table_name, cols)
    session.catalog.create(tbl, replace=True)
    return tbl


def to_dataframe(result) -> Any:
    """A Result as a pandas DataFrame (Result.to_pandas imports pandas)."""
    return result.to_pandas()
