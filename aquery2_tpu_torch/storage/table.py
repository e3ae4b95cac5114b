"""Columnar storage on torch tensors: columns and tables.

Counterpart of ``aquery2_tpu/storage/table.py``. A column is a padded 1-D
tensor on one device plus a logical row count; the capacity is
``config.bucket_size(nrows)`` and padding rows are zeros, exactly as in
the JAX package, so both packages see the same capacities and stats.
Strings are dictionary-encoded: int32 codes on the device, the
``StringDict`` on the host. A ``VectorColumn`` holds one ragged vector per
row in CSR form (flat values and int64 offsets, both tensors): the ordered
path returns its per-group sequences that way.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.runtime.stats import sync
from aquery2_tpu_torch.utils import CaseInsensitiveDict


class StringDict:
    """Append-only string dictionary shared by one or more columns (host
    only; a copy of the JAX package's). Codes are dense int32 from 0."""

    __slots__ = ("_strings", "_index", "_ranks", "_rank_dirty")

    def __init__(self, strings: Iterable[str] = ()) -> None:
        self._strings: list[str] = []
        self._index: dict[str, int] = {}
        self._ranks: np.ndarray | None = None
        self._rank_dirty = True
        for s in strings:
            self.encode_one(s)

    def __len__(self) -> int:
        return len(self._strings)

    def encode_one(self, s: str) -> int:
        code = self._index.get(s)
        if code is None:
            code = len(self._strings)
            self._index[s] = code
            self._strings.append(s)
            self._rank_dirty = True
        return code

    def lookup(self, s: str) -> int:
        """Code for an existing string, or -1 (never matches any row)."""
        return self._index.get(s, -1)

    def encode(self, values: Sequence[str] | np.ndarray) -> np.ndarray:
        out = np.empty(len(values), dtype=np.int32)
        enc = self.encode_one
        for i, v in enumerate(values):
            out[i] = enc(v if isinstance(v, str) else str(v))
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """Each code's string; None for a code the dictionary lacks (-1,
        and every code of an empty dictionary, as an outer join's NULL
        side of an empty table gives)."""
        codes = np.asarray(codes)
        if not self._strings:
            return np.full(codes.shape, None, dtype=object)
        arr = np.asarray(self._strings, dtype=object)
        ok = (codes >= 0) & (codes < len(arr))
        return np.where(ok, arr[np.clip(codes, 0, len(arr) - 1)], None)

    @property
    def ranks(self) -> np.ndarray:
        """rank[code] = position of the string in sorted order."""
        if self._rank_dirty or self._ranks is None:
            order = np.argsort(np.asarray(self._strings, dtype=object),
                               kind="stable")
            ranks = np.empty(len(order), dtype=np.int32)
            ranks[order] = np.arange(len(order), dtype=np.int32)
            self._ranks = ranks
            self._rank_dirty = False
        return self._ranks

    def strings(self) -> list[str]:
        return self._strings


def _pad_to(arr: torch.Tensor, cap: int, fill: Any = 0) -> torch.Tensor:
    n = arr.shape[0]
    if n == cap:
        return arr
    if n > cap:
        raise ValueError(f"array length {n} exceeds capacity {cap}")
    pad = torch.full((cap - n,), fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def _as_tensor(data: torch.Tensor | np.ndarray,
               device: torch.device | str | None) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        if device is not None and data.device != torch.device(device):
            raise ValueError(f"tensor on {data.device}, column wants {device}")
        return data
    if device is None:
        raise ValueError("a column built from host data needs a device")
    arr = np.ascontiguousarray(data)
    if not arr.flags.writeable:      # torch tensors never alias read-only memory
        arr = arr.copy()
    return torch.from_numpy(arr).to(device=device, dtype=T.torch_dtype(arr.dtype))


class Column:
    """One named, typed device column.

    data: tensor of shape (capacity,), capacity = bucket_size(nrows). Rows
    past ``nrows`` are padding (zeros); every kernel masks by length.
    valid: optional bool validity mask of the same shape (None = no NULLs).
    """

    __slots__ = ("name", "sqltype", "data", "nrows", "dictionary", "valid",
                 "_stats", "_fsum")

    def __init__(self, name: str, sqltype: T.SQLType,
                 data: torch.Tensor | np.ndarray, nrows: int | None = None,
                 dictionary: StringDict | None = None,
                 valid: torch.Tensor | np.ndarray | None = None,
                 device: torch.device | str | None = None) -> None:
        self.name = name
        self.sqltype = sqltype
        n = int(data.shape[0]) if nrows is None else int(nrows)
        cap = config.bucket_size(n)
        t = _as_tensor(data, device)
        self.data: torch.Tensor = _pad_to(t[:n], cap)
        self.nrows = n
        self.dictionary = dictionary
        self.valid = (None if valid is None
                      else _pad_to(_as_tensor(valid, t.device)[:n], cap, False))
        self._stats: tuple[int, int] | None = None
        self._fsum: tuple[bool, float] | None = None

    @classmethod
    def from_host(cls, name: str, sqltype: T.SQLType,
                  values: Sequence[Any] | np.ndarray,
                  device: torch.device | str,
                  dictionary: StringDict | None = None) -> "Column":
        """Build from host values; None becomes a NULL (0 + validity
        False)."""
        valid = None
        if not isinstance(values, np.ndarray) and any(v is None for v in values):
            valid = np.asarray([v is not None for v in values], dtype=bool)
            values = [v if v is not None else 0 for v in values]
            if sqltype.is_string:
                values = [v if isinstance(v, str) else "" for v in values]
        if sqltype.is_vector:
            return VectorColumn.from_lists(name, sqltype, values,
                                           device=device,
                                           dictionary=dictionary)
        if sqltype.is_string:
            d = dictionary if dictionary is not None else StringDict()
            return cls(name, sqltype, d.encode(list(values)), dictionary=d,
                       valid=valid, device=device)
        if sqltype.is_temporal:
            values = [v if isinstance(v, (int, np.integer))
                      else T.parse_temporal_literal(sqltype, str(v))
                      for v in values]
        arr = np.asarray(values, dtype=sqltype.np_dtype)
        return cls(name, sqltype, arr, valid=valid, device=device)

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_vector(self) -> bool:
        return False

    def stats(self) -> tuple[int, int]:
        """(min, max) over the valid prefix, cached; one host sync. Float
        columns truncate to int, as in the JAX package."""
        if self._stats is None:
            n = self.nrows
            if n == 0:
                self._stats = (0, 0)
            else:
                d = self.data[:n]
                if self.valid is not None:
                    ok = self.valid[:n]
                    if self.data.dtype.is_floating_point:
                        big, small = float("inf"), float("-inf")
                    else:
                        info = torch.iinfo(self.data.dtype)
                        big, small = info.max, info.min
                    mn = torch.where(ok, d, torch.full_like(d, big)).min()
                    mx = torch.where(ok, d, torch.full_like(d, small)).max()
                else:
                    mn, mx = d.min(), d.max()
                with sync("column.stats"):
                    both = torch.stack([mn, mx]).cpu()
                self._stats = (int(both[0]), int(both[1]))
        return self._stats

    def float_summary(self) -> tuple[bool, float]:
        """(every non-NULL value is finite, the largest finite |value|) of
        a float column over its valid prefix, cached; one host sync. The
        fused tiers read it before they sum the column in integer limbs
        (engine/fused_groupby.float_sums_fit). Not through stats(), whose
        int() raises on NaN and ±inf."""
        if self._fsum is None:
            d = self.data[:self.nrows]
            fin = torch.isfinite(d)
            if self.valid is not None:
                fin = fin | ~self.valid[:self.nrows]
            mag = torch.where(torch.isfinite(d), d.abs(), 0).to(torch.float64)
            both = torch.stack([(~fin).any().to(torch.float64),
                                mag.max() if d.shape[0] else mag.sum()])
            with sync("column.float_summary"):
                bad, mx = both.tolist()
            self._fsum = (not bad, mx)
        return self._fsum

    def with_name(self, name: str) -> "Column":
        """The same column (its tensors shared) under another name."""
        c = Column.__new__(Column)
        for slot in Column.__slots__:
            setattr(c, slot, getattr(self, slot))
        c.name = name
        return c

    def to_numpy(self) -> np.ndarray:
        """Valid-prefix values on the host (raw codes for strings)."""
        return self.data[:self.nrows].cpu().numpy()

    def to_python(self) -> list[Any]:
        """Display values: decoded strings, formatted dates, None for NULLs."""
        raw = self.to_numpy()
        t = self.sqltype
        if t.is_string and self.dictionary is not None:
            out = list(self.dictionary.decode(raw))
        elif t.kind == "date":
            out = [T.format_date(v) for v in raw]
        elif t.kind == "time":
            out = [T.format_time(v) for v in raw]
        elif t.kind == "timestamp":
            out = [T.format_timestamp(v) for v in raw]
        else:
            out = raw.tolist()
        if self.valid is not None:
            ok = self.valid[:self.nrows].cpu().numpy()
            out = [v if k else None for v, k in zip(out, ok)]
        return out

    def __repr__(self) -> str:
        return f"Column({self.name}:{self.sqltype.name}, n={self.nrows})"


class VectorColumn:
    """Ragged column: one vector value per row, in CSR form on the device
    (the JAX package's ``VectorColumn``).

    values: flat tensor, padded to bucket_size(total). offsets: int64
    tensor of shape (capacity + 1,); row i spans values[offsets[i]:
    offsets[i + 1]], and the padding rows are empty."""

    __slots__ = ("name", "sqltype", "values", "offsets", "nrows",
                 "dictionary")
    valid = None                # vector cells are never NULL

    def __init__(self, name: str, sqltype: T.SQLType,
                 values: torch.Tensor | np.ndarray,
                 offsets: torch.Tensor | np.ndarray, nrows: int | None = None,
                 dictionary: StringDict | None = None,
                 total: int | None = None,
                 device: torch.device | str | None = None) -> None:
        if not sqltype.is_vector:
            raise ValueError(f"VectorColumn needs a vector type, got "
                             f"{sqltype}")
        self.name = name
        self.sqltype = sqltype
        n = int(offsets.shape[0]) - 1 if nrows is None else int(nrows)
        self.nrows = n
        off = _as_tensor(offsets, device).to(torch.int64)[:n + 1]
        if total is None:       # pass total to skip this host sync
            total = int(off[-1]) if off.shape[0] else 0
        if off.shape[0] == 0:
            off = torch.zeros(1, dtype=torch.int64, device=off.device)
        self.offsets = _pad_to(off, config.bucket_size(n) + 1, total)
        vals = _as_tensor(values, off.device)[:total]
        self.values = _pad_to(vals, config.bucket_size(max(total, 1)))
        self.dictionary = dictionary

    @classmethod
    def from_lists(cls, name: str, sqltype: T.SQLType,
                   lists: Sequence[Sequence[Any]], *,
                   device: torch.device | str,
                   dictionary: StringDict | None = None) -> "VectorColumn":
        offsets = np.zeros(len(lists) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum([len(r) for r in lists])
        flat = [v for r in lists for v in r]
        if sqltype.elem.is_string:
            d = dictionary if dictionary is not None else StringDict()
            return cls(name, sqltype, d.encode(flat), offsets,
                       dictionary=d, device=device)
        return cls(name, sqltype, np.asarray(flat, sqltype.elem.np_dtype),
                   offsets, device=device)

    @property
    def capacity(self) -> int:
        return int(self.offsets.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def is_vector(self) -> bool:
        return True

    def total_values(self) -> int:
        return int(self.offsets[self.nrows])

    def with_name(self, name: str) -> "VectorColumn":
        """The same column (its tensors shared) under another name."""
        c = VectorColumn.__new__(VectorColumn)
        for slot in VectorColumn.__slots__:
            setattr(c, slot, getattr(self, slot))
        c.name = name
        return c

    def to_numpy(self) -> np.ndarray:
        """The flat values of the valid rows, on the host."""
        return self.values[:self.total_values()].cpu().numpy()

    def offsets_numpy(self) -> np.ndarray:
        """The nrows + 1 row offsets, on the host."""
        return self.offsets[:self.nrows + 1].cpu().numpy()

    def to_python(self) -> list[list[Any]]:
        offs = self.offsets_numpy()
        vals = self.values[:int(offs[-1])].cpu().numpy()
        elem = self.sqltype.elem
        out = []
        for i in range(self.nrows):
            seg = vals[offs[i]:offs[i + 1]]
            if elem is not None and elem.is_string and self.dictionary:
                out.append(list(self.dictionary.decode(seg)))
            else:
                out.append(seg.tolist())
        return out

    def __repr__(self) -> str:
        return f"VectorColumn({self.name}:{self.sqltype.name}, n={self.nrows})"


class Table:
    """Named collection of equal-length columns on one device."""

    def __init__(self, name: str,
                 columns: Iterable[Column | VectorColumn] = ()) -> None:
        self.name = name
        self.columns: CaseInsensitiveDict[Column | VectorColumn] = \
            CaseInsensitiveDict()
        for c in columns:
            self.add_column(c)

    @classmethod
    def from_numpy(cls, name: str, arrays: Mapping[str, Any],
                   types: Mapping[str, T.SQLType] | None = None, *,
                   device: torch.device | str,
                   dictionaries: Mapping[str, StringDict] | None = None
                   ) -> "Table":
        """A table from host arrays (one per column, in order); a column's
        SQL type comes from ``types`` or else from its dtype. A numpy masked
        array makes a nullable column (masked rows are NULL, stored as 0);
        a VectorColumn is taken as it is; ``dictionaries`` gives string
        columns (int32 codes) their StringDict."""
        types = types or {}
        dictionaries = dictionaries or {}
        cols: list[Column | VectorColumn] = []
        for nm, arr in arrays.items():
            if isinstance(arr, VectorColumn):
                cols.append(arr)
                continue
            valid = None
            if isinstance(arr, np.ma.MaskedArray):
                valid = ~np.ma.getmaskarray(arr)
                arr = arr.filled(0)
            cols.append(Column(nm, types.get(nm) or T.from_np_dtype(arr.dtype),
                               arr, valid=valid, dictionary=dictionaries.get(nm),
                               device=device))
        return cls(name, cols)

    @classmethod
    def from_reference(cls, ref_table: Any,
                       device: torch.device | str) -> "Table":
        """The port's copy of an ``aquery2_tpu`` Table. Reads each column's
        data, validity, row count, SQL type name and string dictionary as
        attributes only (no jax import)."""
        cols: list[Column | VectorColumn] = []
        for rc in ref_table.columns.values():
            d = (None if rc.dictionary is None
                 else StringDict(rc.dictionary.strings()))
            if getattr(rc, "is_vector", False):
                n = int(rc.nrows)
                offs = np.asarray(rc.offsets)[:n + 1]
                cols.append(VectorColumn(
                    rc.name, T.from_sql_name(rc.sqltype.name),
                    np.asarray(rc.values)[:int(offs[-1])], offs, nrows=n,
                    dictionary=d, device=device))
                continue
            n = int(rc.nrows)
            valid = (None if rc.valid is None
                     else np.asarray(rc.valid)[:n].astype(bool))
            cols.append(Column(rc.name, T.from_sql_name(rc.sqltype.name),
                               np.asarray(rc.data)[:n], nrows=n,
                               dictionary=d, valid=valid, device=device))
        return cls(ref_table.name, cols)

    def add_column(self, col: "Column | VectorColumn") -> None:
        if len(self.columns) and col.nrows != self.nrows:
            raise ValueError(f"column {col.name} has {col.nrows} rows, "
                             f"table {self.name} has {self.nrows}")
        self.columns[col.name] = col

    @property
    def nrows(self) -> int:
        for c in self.columns.values():
            return c.nrows
        return 0

    @property
    def ncols(self) -> int:
        return len(self.columns)

    def column_names(self) -> list[str]:
        return list(self.columns)

    def schema(self) -> list[tuple[str, T.SQLType]]:
        return [(c.name, c.sqltype) for c in self.columns.values()]

    def has_nulls(self, names: Iterable[str] | None = None) -> bool:
        """True if any column (of ``names``, where given) has a validity
        mask."""
        cols = (self.columns.values() if names is None
                else [self.columns[n] for n in names if n in self.columns])
        return any(nullable(c) for c in cols)

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def append_rows(self, rows: Sequence[Sequence[Any]]) -> None:
        """INSERT INTO ... VALUES: append host rows to the device columns."""
        if not rows:
            return
        cols = list(self.columns.values())
        if any(len(r) != len(cols) for r in rows):
            raise ValueError("row arity mismatch")
        for j, col in enumerate(cols):
            self.columns[col.name] = _append_host_values(
                col, [r[j] for r in rows])

    def append_table(self, other: "Table") -> None:
        """INSERT INTO t SELECT …, UNION ALL: append another table's rows,
        column by column in order, on the device."""
        if other.nrows == 0:
            return
        mine = list(self.columns.values())
        theirs = list(other.columns.values())
        if len(mine) != len(theirs):
            raise ValueError("column count mismatch in append")
        for col, src in zip(mine, theirs):
            self.columns[col.name] = _append_column(col, src)

    def head(self, k: int = 10) -> str:
        """The first k rows as ``Result.format`` prints them."""
        from aquery2_tpu_torch.storage.result import Result

        return Result(self).format(limit=k)

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.sqltype.name}"
                         for c in self.columns.values())
        return f"Table({self.name}: [{cols}] x {self.nrows})"


def nullable(c) -> bool:
    """Whether a column has a validity mask (a column placed on a mesh
    says so without its mask, parallel/mesh.py)."""
    flag = getattr(c, "nullable", None)
    return flag if flag is not None else c.valid is not None


def _append_host_values(col: Column | VectorColumn,
                        vals: Sequence[Any]) -> Column | VectorColumn:
    if col.is_vector:
        lists = [v if isinstance(v, (list, tuple)) else [v] for v in vals]
        add = VectorColumn.from_lists(col.name, col.sqltype, lists,
                                      device=col.device,
                                      dictionary=col.dictionary)
    else:
        add = Column.from_host(col.name, col.sqltype, vals,
                               device=col.device, dictionary=col.dictionary)
    return _append_column(col, add)


def _append_column(col: Column | VectorColumn,
                   src: Column | VectorColumn) -> Column | VectorColumn:
    """src's rows under col's, in col's type; string codes of another
    dictionary are re-coded into col's (which gains src's new strings)."""
    if col.is_vector or src.is_vector:
        if not (col.is_vector and src.is_vector):
            raise ValueError(f"cannot append {src!r} to {col!r}")
        n1, n2 = col.nrows, src.nrows
        t1, t2 = col.total_values(), src.total_values()
        vals = torch.cat([col.values[:t1],
                          recode(src.values[:t2], src.dictionary,
                                 col.dictionary).to(col.values.dtype)])
        offsets = torch.cat([col.offsets[:n1 + 1],
                             src.offsets[1:n2 + 1] + t1])
        return VectorColumn(col.name, col.sqltype, vals, offsets,
                            nrows=n1 + n2, dictionary=col.dictionary,
                            total=t1 + t2)
    n1, n2 = col.nrows, src.nrows
    dictionary = col.dictionary
    if col.sqltype.is_string and dictionary is None:
        dictionary = src.dictionary
    data = torch.cat([col.data[:n1],
                      recode(src.data[:n2], src.dictionary,
                             col.dictionary).to(col.data.dtype)])
    valid = None
    if col.valid is not None or src.valid is not None:
        def mask(c: Column, k: int) -> torch.Tensor:
            if c.valid is not None:
                return c.valid[:k]
            return torch.ones(k, dtype=torch.bool, device=c.device)
        valid = torch.cat([mask(col, n1), mask(src, n2)])
    return Column(col.name, col.sqltype, data, nrows=n1 + n2,
                  dictionary=dictionary, valid=valid)


def recode(codes: torch.Tensor, src: StringDict | None,
           dst: StringDict | None) -> torch.Tensor:
    """String codes of dictionary src as codes of dst, which gains src's
    strings it lacks (unchanged where either is None or they are one)."""
    if dst is None or src is None or src is dst or not len(src):
        return codes
    remap = torch.tensor(dst.encode(src.strings()), dtype=codes.dtype,
                         device=codes.device)
    return remap[codes.clamp(0, len(src) - 1).long()]
