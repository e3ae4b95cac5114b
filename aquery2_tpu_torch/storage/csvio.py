"""CSV ingest: LOAD [COMPLEX] DATA INFILE.

Counterpart of ``aquery2_tpu/storage/csvio.py`` (the reference's MonetDB
``COPY OFFSET 2`` for plain loads, engine/ast.py:1427-1437, and its
generated ``AQCSVReader`` loop for ``LOAD COMPLEX DATA``,
engine/ast.py:1448-1496), without pandas. Three routes, chosen from the
table's schema before the file is read (``route``):

* ``native``, for a plain load with a one-byte separator into a table
  whose columns are all int32, int64, float32 or float64: the C++
  scanner (native/csvscan.cpp, built at first use), which reads the file
  once in up to 16 threads straight into the columns. A cell it cannot
  read (a float or an out-of-range number in an integer column, any
  other text) or a line without one field per column raises ValueError.
* ``loadtxt`` (``_load_numpy``), for any other plain load with a
  one-byte separator: ``np.loadtxt``'s C parser reads the file once into
  a structured array. A byte scan first looks for an empty cell
  (``_has_empty_cell``). Where there is none, numeric columns parse
  straight into their dtype (an integer cell that parses only as a
  float fails); where there is one, numeric columns are read as
  strings, an empty one is NULL and the rest are cast (``astype`` of
  the strings: Python's ``int`` and ``float``, the line reader's own
  parse). String, temporal and bool columns are read as
  strings. A cell that does not parse, or a row whose field count
  differs from the schema, raises loadtxt's ValueError, as it raises in
  the line reader.
* ``lines`` (``_load_python``), for LOAD COMPLEX DATA (vector cells split
  by the element separator), a table with a vector column and a longer
  or non-ASCII separator: a line-by-line reader, the JAX package's.

Every route gives the JAX package's table: the first line is a header
(skipped) when it does not parse under the schema; an empty or blank
cell is NULL except in a string column, where it is ""; a blank line is
skipped; cells are stripped; temporal cells parse through
``types.parse_temporal_literal``; bool cells are true for 1, true, t,
yes; string cells are coded into the column's dictionary in the order
they first appear. Where the JAX package's own scanner reads a cell
wrongly (nan and inf as 0, a float in an INT column truncated, an int32
overflow wrapped, a blank line as a row of NULLs), the port follows
numpy and SQL.
"""

from __future__ import annotations

import warnings

import numpy as np

from aquery2_tpu_torch import native
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.storage.table import (Column, StringDict, Table,
                                             VectorColumn, _append_column)

_TRUE = ("1", "true", "t", "yes")


def _parse_cell(t: T.SQLType, tok: str):
    tok = tok.strip()
    if tok == "" and t.kind != "str":
        return None                     # empty cell: NULL
    if t.kind == "int":
        return int(tok)
    if t.kind == "float":
        return float(tok)
    if t.is_temporal:
        return T.parse_temporal_literal(t, tok)
    if t.kind == "bool":
        return tok.lower() in _TRUE
    return tok


def _line_parses(schema, toks) -> bool:
    if len(toks) != len(schema):
        return False
    try:
        for (_, t), tok in zip(schema, toks):
            if not t.is_vector:
                _parse_cell(t, tok)
        return True
    except (ValueError, TypeError):
        return False


def _schema(table: Table):
    return [(c.name, c.sqltype) for c in table.columns.values()]


def route(table: Table, field_sep: str = ",",
          complex_cells: bool = False) -> str:
    """The route a LOAD into ``table`` takes: "native", "loadtxt" or
    "lines"."""
    schema = _schema(table)
    if complex_cells or any(t.is_vector for _, t in schema) \
            or len(field_sep.encode()) != 1:
        return "lines"
    if schema and all(t.kind in ("int", "float")
                      and t.np_dtype.name in native.SPEC for _, t in schema):
        return "native"
    return "loadtxt"


def load_csv_into(table: Table, path: str, field_sep: str = ",",
                  element_sep: str = ";", complex_cells: bool = False) -> int:
    """Append the file's rows to an existing table; the rows loaded."""
    r = route(table, field_sep, complex_cells)
    if r == "native":
        return _load_native(table, path, field_sep)
    if r == "loadtxt":
        return _load_numpy(table, path, field_sep)
    return _load_python(table, path, field_sep, element_sep)


def _load_native(table: Table, path: str, sep: str) -> int:
    schema = _schema(table)
    first = _first_line(path)
    if first is None:
        return 0
    cols, masks = native.parse_numeric_csv(
        path, [t.np_dtype for _, t in schema], sep,
        skip_header=not _line_parses(schema, first.split(sep)))
    device = next(iter(table.columns.values())).device
    for (name, t), arr, valid in zip(schema, cols, masks):
        table.columns[name] = _append_column(
            table.columns[name], Column(name, t, arr, valid=valid,
                                        device=device))
    return len(cols[0])


def _first_line(path: str) -> str | None:
    with open(path) as f:
        for line in f:
            return line.rstrip("\r\n")
    return None


def _encode_first_seen(d: StringDict, strs: np.ndarray) -> np.ndarray:
    """int32 codes of strs in d, new strings added in the order they
    first appear (as a row-by-row encode would add them)."""
    if strs.shape[0] == 0:
        return np.zeros(0, np.int32)
    uniq, first, inv = np.unique(strs, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    codes = np.empty(len(uniq), np.int32)
    codes[order] = d.encode([str(s) for s in uniq[order]])
    return codes[inv.reshape(-1)]


def _has_empty_cell(path: str, sep: str) -> bool:
    """Whether a field of the file is empty or blank: once blanks and
    carriage returns are deleted, the separator next to another, to a
    line's start or end, or to the file's start or end. Read in blocks
    (so that the scan holds one block, not the file) and searched with
    ``bytes.translate`` and ``in``, which run in C."""
    s = sep.encode()
    blanks = bytes(c for c in b" \t\r" if c != s[0])
    prev = b"\n"                                    # the file starts a line
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 26)
            end = not block
            if any(c in block for c in blanks):
                block = block.translate(None, blanks)
            b = prev + (b"\n" if end else block)   # the file ends a line
            if s + s in b or s + b"\n" in b or b"\n" + s in b:
                return True
            if end:
                return False
            prev = b[-1:]


def _load_numpy(table: Table, path: str, sep: str) -> int:
    schema = _schema(table)
    first = _first_line(path)
    if first is None:
        return 0
    skip = 0 if _line_parses(schema, first.split(sep)) else 1
    typed = not _has_empty_cell(path, sep)
    dtype = [(f"f{j}", t.np_dtype if typed and t.kind in ("int", "float")
              else object) for j, (_, t) in enumerate(schema)]
    with warnings.catch_warnings():
        # numpy reads an integer cell that only parses as a float (1.5,
        # 1e5, 3000000000 in an INT column) through the float, with a
        # DeprecationWarning; the cell fails here, as in the line reader
        warnings.simplefilter("error", DeprecationWarning)
        try:
            rec = np.loadtxt(path, delimiter=sep, dtype=dtype, skiprows=skip,
                             comments=None, ndmin=1, encoding="utf-8")
        except DeprecationWarning:
            raise ValueError(f"{path}: an integer column holds a cell that "
                             f"is not an integer of its type") from None
    rows = int(rec.shape[0])
    if rows == 0:
        return 0
    device = next(iter(table.columns.values())).device
    adds = []
    for j, (name, t) in enumerate(schema):
        col = table.columns[name]
        raw = rec[f"f{j}"]
        if typed and t.kind in ("int", "float"):
            adds.append(Column(name, t, np.ascontiguousarray(raw),
                               device=device))
            continue
        strs = np.char.strip(raw.astype(str))
        if t.is_string:
            d = col.dictionary if col.dictionary is not None else StringDict()
            adds.append(Column(name, t, _encode_first_seen(d, strs),
                               dictionary=d, device=device))
            continue
        empty = strs == ""
        if t.kind in ("int", "float"):
            vals = np.zeros(rows, t.np_dtype)
            vals[~empty] = raw[~empty].astype(t.np_dtype)
        elif t.kind == "bool":
            vals = np.isin(np.char.lower(strs), _TRUE)
        else:                                   # date, time, timestamp
            uniq, inv = np.unique(strs, return_inverse=True)
            parsed = np.asarray([0 if s == "" else
                                 T.parse_temporal_literal(t, str(s))
                                 for s in uniq], dtype=t.np_dtype)
            vals = parsed[inv.reshape(-1)]
        adds.append(Column(name, t, vals.astype(t.np_dtype),
                           valid=~empty if empty.any() else None,
                           device=device))
    for add in adds:
        table.columns[add.name] = _append_column(table.columns[add.name], add)
    return rows


def _load_python(table: Table, path: str, field_sep: str,
                 element_sep: str) -> int:
    schema = _schema(table)
    host_cols: list[list] = [[] for _ in schema]
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        return 0
    start = 0 if _line_parses(schema, lines[0].split(field_sep)) else 1
    count = 0
    for line in lines[start:]:
        if not line.strip():
            continue
        toks = line.split(field_sep)
        if len(toks) != len(schema):
            raise ValueError(f"{path}: row has {len(toks)} fields, "
                             f"expected {len(schema)}")
        for j, ((_, t), tok) in enumerate(zip(schema, toks)):
            if t.is_vector:
                elems = [e for e in tok.split(element_sep) if e.strip() != ""]
                host_cols[j].append([_parse_cell(t.elem, e) for e in elems])
            else:
                host_cols[j].append(_parse_cell(t, tok))
        count += 1
    device = next(iter(table.columns.values())).device
    for j, (name, t) in enumerate(schema):
        col = table.columns[name]
        if t.is_vector:
            add = VectorColumn.from_lists(name, t, host_cols[j],
                                          device=device,
                                          dictionary=col.dictionary)
        elif t.is_string:
            d = col.dictionary if col.dictionary is not None else StringDict()
            add = Column(name, t, d.encode([str(v) for v in host_cols[j]]),
                         dictionary=d, device=device)
        else:
            add = Column.from_host(name, t, host_cols[j], device=device)
        table.columns[name] = _append_column(col, add)
    return count
