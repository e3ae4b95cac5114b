"""SQL type system for aquery2_tpu_torch.

A copy of ``aquery2_tpu/types.py`` (the reference's ``common/types.py``
counterpart), so both packages name the same SQL types; the port adds
``torch_dtype``, the numpy → torch dtype map its device tensors use.

* each SQL type maps to a numpy dtype and a logical kind;
* strings are dictionary-encoded: the device dtype is int32 codes, the
  dictionary lives host-side (SURVEY.md §7 "Strings");
* date/time/timestamp are stored as integer days / seconds / microseconds
  since epoch (the reference packs them into custom structs,
  server/libaquery.h:225-276 — an int encoding is the TPU-native choice);
* aggregate promotion mirrors the reference: integer sums accumulate in
  int64 (``GetLongType``, reference common/types.py:211-222), averages and
  ratios are float64 (``GetFPType``).
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class SQLType:
    name: str                  # canonical SQL name
    np_dtype: np.dtype         # host/device representation
    kind: str                  # 'int' | 'float' | 'bool' | 'str' | 'date' | 'time' | 'timestamp' | 'vec'
    priority: int              # promotion priority (higher wins)
    elem: "SQLType | None" = field(default=None)  # element type for vec types

    @property
    def is_numeric(self) -> bool:
        return self.kind in ("int", "float", "bool")

    @property
    def is_vector(self) -> bool:
        return self.kind == "vec"

    @property
    def is_string(self) -> bool:
        return self.kind == "str"

    @property
    def is_temporal(self) -> bool:
        return self.kind in ("date", "time", "timestamp")

    def __repr__(self) -> str:  # compact for planner dumps
        return f"<{self.name}>"


def _t(name: str, dtype: str, kind: str, prio: int) -> SQLType:
    return SQLType(name, np.dtype(dtype), kind, prio)


BoolT = _t("bool", "bool", "bool", 0)
ByteT = _t("tinyint", "int8", "int", 1)
ShortT = _t("smallint", "int16", "int", 2)
IntT = _t("int", "int32", "int", 3)
LongT = _t("bigint", "int64", "int", 4)
UIntT = _t("uint", "uint32", "int", 3)
ULongT = _t("ubigint", "uint64", "int", 4)
FloatT = _t("real", "float32", "float", 5)
DoubleT = _t("double", "float64", "float", 6)
# Strings: device codes are int32 into a host dictionary.
StrT = _t("varchar", "int32", "str", 7)
# Temporal: integer encodings (days / seconds / microseconds since epoch).
DateT = _t("date", "int32", "date", 8)
TimeT = _t("time", "int64", "time", 8)
TimestampT = _t("timestamp", "int64", "timestamp", 8)


def VectorT(elem: SQLType) -> SQLType:
    """Ragged vector-of-elem type (reference VectorT, common/types.py:123-142);
    stored CSR-style as (flat values, offsets)."""
    return SQLType(f"vec{elem.name}", elem.np_dtype, "vec", 9, elem)


VecIntT = VectorT(IntT)
VecLongT = VectorT(LongT)
VecFloatT = VectorT(FloatT)
VecDoubleT = VectorT(DoubleT)
VecBoolT = VectorT(BoolT)
VecStrT = VectorT(StrT)
VecVecDoubleT = VectorT(VecDoubleT)
VecVecFloatT = VectorT(VecFloatT)
VecVecIntT = VectorT(VecIntT)

# SQL-name → type lookup (case-insensitive). Mirrors the name aliases the
# reference grammar accepts (aquery_parser/types.py; common/types.py:76-80).
_ALIASES: dict[str, SQLType] = {}


def _alias(t: SQLType, *names: str) -> None:
    for n in names:
        _ALIASES[n.lower()] = t


_alias(BoolT, "bool", "boolean")
_alias(ByteT, "tinyint", "int8")
_alias(ShortT, "smallint", "int16")
_alias(IntT, "int", "integer", "int32")
_alias(LongT, "bigint", "int64", "long")
_alias(UIntT, "uint", "uint32")
_alias(ULongT, "ubigint", "uint64")
_alias(FloatT, "real", "float32")
# NOTE: the reference maps SQL FLOAT to double-width on MonetDB; we follow
# common usage: FLOAT/REAL → float32, DOUBLE → float64.
_alias(FloatT, "float")
_alias(DoubleT, "double", "float64", "decimal", "numeric")
_alias(StrT, "varchar", "string", "text", "char")
_alias(DateT, "date")
_alias(TimeT, "time")
_alias(TimestampT, "timestamp", "datetime")
_alias(VecIntT, "vecint", "vecint32", "vecinteger")
_alias(VecLongT, "vecint64", "vecbigint", "veclong")
_alias(VecFloatT, "vecfloat", "vecreal")
_alias(VecDoubleT, "vecdouble")
_alias(VecBoolT, "vecbool")
_alias(VecStrT, "vecstr", "vecvarchar")
_alias(VecVecDoubleT, "vecvecdouble")
_alias(VecVecFloatT, "vecvecfloat")
_alias(VecVecIntT, "vecvecint")


def from_sql_name(name: str) -> SQLType:
    """Resolve a SQL type name like 'varchar(10)' / 'INT' / 'vecdouble'."""
    base = name.strip().lower()
    if "(" in base:
        base = base[: base.index("(")].strip()
    try:
        return _ALIASES[base]
    except KeyError:
        raise ValueError(f"unknown SQL type: {name!r}") from None


def from_np_dtype(dt: np.dtype) -> SQLType:
    dt = np.dtype(dt)
    for t in (BoolT, ByteT, ShortT, IntT, LongT, UIntT, ULongT, FloatT, DoubleT):
        if t.np_dtype == dt:
            return t
    if dt.kind in ("U", "S", "O"):
        return StrT
    raise ValueError(f"no SQL type for dtype {dt}")


_TORCH_DTYPES: dict[np.dtype, torch.dtype] = {
    np.dtype("bool"): torch.bool,
    np.dtype("int8"): torch.int8,
    np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32,
    np.dtype("int64"): torch.int64,
    np.dtype("uint32"): torch.uint32,
    np.dtype("uint64"): torch.uint64,
    np.dtype("float32"): torch.float32,
    np.dtype("float64"): torch.float64,
}
_NP_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(dt) -> torch.dtype:
    """numpy dtype → the torch dtype a device column of it is stored in."""
    try:
        return _TORCH_DTYPES[np.dtype(dt)]
    except KeyError:
        raise ValueError(f"no torch dtype for {dt}") from None


def np_dtype(dt: torch.dtype) -> np.dtype:
    """torch dtype → numpy dtype (inverse of torch_dtype)."""
    try:
        return _NP_DTYPES[dt]
    except KeyError:
        raise ValueError(f"no numpy dtype for {dt}") from None


# --- promotion rules ------------------------------------------------------

def promote(a: SQLType, b: SQLType) -> SQLType:
    """Binary-op result type (reference auto_extension / Coercion,
    common/types.py:211-256): higher priority wins; int+float → float."""
    if a.kind == "vec" or b.kind == "vec":
        ea = a.elem if a.kind == "vec" else a
        eb = b.elem if b.kind == "vec" else b
        return VectorT(promote(ea, eb))
    if a.is_string or b.is_string:
        return StrT
    if a.is_temporal:
        return a
    if b.is_temporal:
        return b
    return a if a.priority >= b.priority else b


def long_type(t: SQLType) -> SQLType:
    """Accumulator type for SUM (reference GetLongType: ints widen to 64-bit,
    floats to double; common/types.py:211-222)."""
    if t.kind == "vec":
        return VectorT(long_type(t.elem))
    if t.kind == "float":
        return DoubleT
    if t.kind in ("int", "bool"):
        return ULongT if t.np_dtype.kind == "u" else LongT
    return t


def fp_type(t: SQLType) -> SQLType:
    """Result type for AVG / ratios (reference GetFPType → double,
    common/types.py:223-235)."""
    if t.kind == "vec":
        return VectorT(fp_type(t.elem))
    if t is FloatT:
        return FloatT
    return DoubleT


def div_type(a: SQLType, b: SQLType) -> SQLType:
    """SQL '/' on two ints yields float (reference renders int division
    through fp promotion in codegen)."""
    p = promote(a, b)
    if p.kind == "int" or p.kind == "bool":
        return DoubleT
    return p


# --- temporal parsing -----------------------------------------------------

_EPOCH = _dt.date(1970, 1, 1)


def parse_date(s: str) -> int:
    """'2003-01-10' → days since epoch (int32)."""
    d = _dt.date.fromisoformat(s.strip())
    return (d - _EPOCH).days


def parse_time(s: str) -> int:
    """'13:45:30[.123456]' → microseconds since midnight (int64)."""
    t = _dt.time.fromisoformat(s.strip())
    return ((t.hour * 60 + t.minute) * 60 + t.second) * 1_000_000 + t.microsecond


def parse_timestamp(s: str) -> int:
    """ISO timestamp → microseconds since epoch (int64)."""
    ts = _dt.datetime.fromisoformat(s.strip())
    return int(ts.replace(tzinfo=_dt.timezone.utc).timestamp() * 1_000_000)


def format_date(days: int) -> str:
    return (_EPOCH + _dt.timedelta(days=int(days))).isoformat()


def format_time(us: int) -> str:
    us = int(us)
    s, us = divmod(us, 1_000_000)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    base = f"{h:02d}:{m:02d}:{s:02d}"
    return f"{base}.{us:06d}" if us else base


def format_timestamp(us: int) -> str:
    return _dt.datetime.fromtimestamp(int(us) / 1_000_000, _dt.timezone.utc).strftime(
        "%Y-%m-%d %H:%M:%S.%f"
    ).rstrip("0").rstrip(".")


def parse_temporal_literal(t: SQLType, s: str) -> int:
    if t.kind == "date":
        return parse_date(s)
    if t.kind == "time":
        return parse_time(s)
    return parse_timestamp(s)
