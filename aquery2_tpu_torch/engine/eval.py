"""Expression evaluation of the general engine, grouped and ungrouped.

Counterpart of ``aquery2_tpu/engine/eval.py``. Every expression evaluates
to tensors on the session's device, tagged with a kind:

  'scalar' : a Python value or 0-d tensor (literals, whole-table values)
  'row'    : one value per row [capacity] (columns, running aggregates)
  'group'  : one value per group [gcap] (aggregates)

Mixing kinds broadcasts: group → row by a gather through each row's group
id, scalar → anything. An ungrouped query evaluates as one group, so
``SELECT max(price - mins(price))`` and an aggregate beside a bare column
follow the same rules.

NULLs: a Value's ``nulls`` mask (True = NULL) comes from the columns'
validity. Arithmetic and comparisons are NULL where an operand is; AND and
OR are Kleene (NULL AND false = false, NULL OR true = true); NOT NULL is
NULL; CASE never takes a NULL condition; aggregates skip NULL arguments
(the evaluator folds them into the argument's ``mask``).

OVER windows (``_window``) sort the rows once by (validity, partition
keys, order keys) and compute every frame with the segmented scans of
ops/window.py. User FUNCTIONs are inlined (engine/udf.py). A loaded
module's function runs on the host (sdk/modules.call_module_function).
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import fused_groupby as fg
from aquery2_tpu_torch.engine import udf as udf_mod
from aquery2_tpu_torch.ops import scan
from aquery2_tpu_torch.ops import window as W
from aquery2_tpu_torch.ops.reduce import big_of, small_of
from aquery2_tpu_torch.ops.sort import lexsort
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.runtime.stats import sync
from aquery2_tpu_torch.storage.table import StringDict, Table


class EvalError(Exception):
    pass


@dataclass
class Value:
    kind: str                          # 'scalar' | 'row' | 'group'
    data: Any                          # Python value or tensor
    sqltype: T.SQLType
    dictionary: StringDict | None = None
    mask: torch.Tensor | None = None   # row kind: rows an aggregate reads
    pack_cols: list | None = None      # pack(): the row tensors packed
    nulls: torch.Tensor | None = None  # True = NULL; None = no NULLs


@dataclass
class _Layout:
    """A window's sorted domain: the permutation into it, and there each
    row's validity, partition and peer-group starts, position in its
    partition (int32) and its partition's first and last row (int64)."""
    perm: torch.Tensor
    valid_s: torch.Tensor
    flags: torch.Tensor
    peer_flags: torch.Tensor
    pos: torch.Tensor
    start: torch.Tensor
    last: torch.Tensor

    def unsort(self, a: torch.Tensor) -> torch.Tensor:
        """a, in the sorted domain, back in row order (one scatter)."""
        out = torch.empty_like(a)
        out[self.perm] = a
        return out


_MATH_FNS = {
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log, "ln": torch.log,
    "log2": torch.log2, "log10": torch.log10, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "abs": torch.abs,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "sign": torch.sign,
}

AGG_NAMES = {"sum", "avg", "mean", "min", "max", "count", "var", "stddev",
             "corr", "median", "first", "last", "distinct_count"}

_RUNNING_NAMES = set(scan.RUNNING)
_WINDOW_EXPLICIT = {"sumw": "sums", "avgw": "avgs", "minw": "mins",
                    "maxw": "maxs", "varw": "vars", "stddevw": "stddevs",
                    "ratiow": "ratios"}


class WorkingSet:
    """The current row layout over one or more source tables: one row
    index tensor per source (None = identity), so ASSUMING sorts, filters
    and grouping compose by permutation without copying every column;
    gathered columns are cached."""

    def __init__(self, sources: list[tuple[str | None, Table]],
                 indices: list[torch.Tensor | None], n: int, capacity: int,
                 device: torch.device,
                 missing: list[torch.Tensor | None] | None = None,
                 merged: list[tuple[str, int, int, bool]] | None = None
                 ) -> None:
        self.sources = sources
        self.indices = indices
        self.n = n
        self.capacity = capacity
        self.device = device
        # per source, True where it contributed no row (an outer join's
        # NULL side): every column of that source reads NULL there
        self.missing = missing if missing is not None \
            else [None] * len(sources)
        # a NATURAL or USING join's keys, which SELECT * shows once: (name,
        # left source, right source, coalesce); a RIGHT or FULL join's key
        # is COALESCE(left, right)
        self.merged = merged if merged is not None else []
        self._cache: dict[tuple[int, str], torch.Tensor] = {}

    @classmethod
    def from_table(cls, table: Table, device: torch.device,
                   alias: str | None = None) -> "WorkingSet":
        cap = config.bucket_size(max(table.nrows, 1))
        return cls([(alias or table.name, table)], [None], table.nrows, cap,
                   device)

    def find(self, name: str, qualifier: str | None = None):
        """(source index, column), or raise EvalError."""
        for si, (alias, tbl) in enumerate(self.sources):
            if qualifier and (alias or "").lower() != qualifier.lower() \
                    and tbl.name.lower() != qualifier.lower():
                continue
            if name in tbl.columns:
                return si, tbl.columns[name]
        q = f"{qualifier}." if qualifier else ""
        raise EvalError(f"unknown column {q}{name}")

    def has_column(self, name: str, qualifier: str | None = None) -> bool:
        try:
            self.find(name, qualifier)
            return True
        except EvalError:
            return False

    def _take(self, si: int, arr: torch.Tensor) -> torch.Tensor:
        """arr (a [capacity] column tensor of source si) in working-set row
        order, [self.capacity] rows."""
        idx = self.indices[si]
        if idx is None:
            out = arr[:self.capacity]
            if out.shape[0] < self.capacity:
                out = torch.cat([out, out.new_zeros(self.capacity
                                                    - out.shape[0])])
            return out
        return arr[idx[:self.capacity].clamp(0, arr.shape[0] - 1)]

    def gather(self, si: int, col) -> torch.Tensor:
        key = (si, col.name.lower())
        if key not in self._cache:
            self._cache[key] = self._take(si, col.data)
        return self._cache[key]

    def gather_nulls(self, si: int, col) -> torch.Tensor | None:
        """NULL mask in working-set row order, or None."""
        miss = self.missing[si]
        if col.valid is None and miss is None:
            return None
        key = (si, "\0nulls\0" + col.name.lower())
        if key not in self._cache:
            out = miss[:self.capacity] if col.valid is None \
                else self._take(si, ~col.valid)
            if col.valid is not None and miss is not None:
                out = out | miss[:self.capacity]
            self._cache[key] = out
        return self._cache[key]

    def column_value(self, name: str, qualifier: str | None = None) -> Value:
        si, col = self.find(name, qualifier)
        if col.is_vector:
            raise EvalError(f"vector column {name} can only be passed whole "
                            f"in this context")
        return Value("row", self.gather(si, col), col.sqltype,
                     dictionary=col.dictionary,
                     nulls=self.gather_nulls(si, col))

    def all_columns(self, qualifier: str | None = None
                    ) -> list[tuple[str, Value | tuple]]:
        """SELECT * (or ``t.*``, the sources named t): (name, Value or
        (source index, VectorColumn)) in schema order. A NATURAL or USING
        join's key comes once, at its left column (``merged``); every
        other repeated name stays, for output_names to suffix. A
        qualified star shows its sources' own columns."""
        out: list[tuple[str, Any]] = []
        keys: dict[tuple[int, str], list[tuple[int, bool]]] = {}
        for nm, li, ri, co in () if qualifier else self.merged:
            keys.setdefault((li, nm), []).append((ri, co))
        dropped = {(ri, nm) for (_li, nm), rs in keys.items() for ri, _ in rs}
        for si, (alias, tbl) in enumerate(self.sources):
            if qualifier and qualifier.lower() not in (
                    (alias or "").lower(), tbl.name.lower()):
                continue
            for col in tbl.columns.values():
                k = (si, col.name.lower())
                if k in dropped:
                    continue
                if col.is_vector:
                    out.append((col.name, (si, col)))
                    continue
                v = Value("row", self.gather(si, col), col.sqltype,
                          col.dictionary, nulls=self.gather_nulls(si, col))
                for ri, co in keys.get(k, ()):
                    if co:
                        rcol = self.sources[ri][1].columns[col.name]
                        v = _coalesce(v, Value(
                            "row", self.gather(ri, rcol), rcol.sqltype,
                            rcol.dictionary,
                            nulls=self.gather_nulls(ri, rcol)))
                out.append((col.name, v))
        return out

    def permuted(self, perm: torch.Tensor, new_n: int) -> "WorkingSet":
        """The rows in the order perm gives (len(perm) is the new
        capacity; rows at or past new_n are padding)."""
        idxs = [perm if idx is None else idx[perm.clamp(0, idx.shape[0] - 1)]
                for idx in self.indices]
        miss = [None if m is None else m[perm.clamp(0, m.shape[0] - 1)]
                for m in self.missing]
        return WorkingSet(self.sources, idxs, new_n, int(perm.shape[0]),
                          self.device, missing=miss, merged=self.merged)


class EvalContext:
    """Evaluation state: the working set, its grouping, the session."""

    def __init__(self, ws: WorkingSet, session=None, grouping=None) -> None:
        self.ws = ws
        self.session = session
        self.grouping = grouping        # rows already permuted by it
        self.env: list[dict[str, Value]] = []   # FUNCTION locals, inner last
        self._layouts: dict[str, _Layout] = {}  # each window's sort, by spec
        dev = ws.device
        if grouping is not None:
            self.G = grouping.num_groups
            self.gcap = config.bucket_size(max(self.G, 1))
            self.seg = grouping.sorted_seg
            self.pos = grouping.pos
            self.flags = grouping.flags
            off = grouping.offsets
            pad = torch.zeros(self.gcap - self.G, dtype=off.dtype, device=dev)
            self.group_starts = torch.cat([off[:self.G], pad])
            self.group_ends = torch.cat([off[1:self.G + 1], pad])
        else:
            self.G = 1
            self.gcap = 1
            idx = torch.arange(ws.capacity, device=dev)
            self.seg = (idx >= ws.n).to(torch.int64)
            self.pos = idx.to(torch.int32)
            self.flags = None
            self.group_starts = torch.zeros(1, dtype=torch.int64, device=dev)
            self.group_ends = torch.full((1,), ws.n, dtype=torch.int64,
                                         device=dev)
        self.group_lens = self.group_ends - self.group_starts

    def np_offsets(self) -> np.ndarray:
        """Group g's rows are [offsets[g], offsets[g + 1]) of the row
        layout, on the host (the host interpreter's per-group slices)."""
        if self.grouping is not None:
            return self.grouping.offsets.cpu().numpy()
        return np.asarray([0, self.ws.n], dtype=np.int64)

    # -- kind coercion -----------------------------------------------------

    def to_row(self, v: Value) -> Value:
        if v.kind != "group":
            return v
        seg = self.seg.clamp(0, v.data.shape[0] - 1)
        return Value("row", v.data[seg], v.sqltype, v.dictionary,
                     nulls=None if v.nulls is None else v.nulls[seg])

    def _kind_shape(self, kind: str) -> tuple:
        if kind == "row":
            return (self.ws.capacity,)
        if kind == "group":
            return (self.gcap,)
        return ()

    # -- dispatch ----------------------------------------------------------

    def eval(self, e: A.Expr) -> Value:
        if isinstance(e, A.Literal):
            return _literal(e)
        if isinstance(e, A.ColumnRef):
            for frame in reversed(self.env):    # FUNCTION locals shadow
                if e.table is None and e.name in frame:
                    return frame[e.name]
            return self.ws.column_value(e.name, e.table)
        if isinstance(e, A.BinOp):
            return self._binop(e)
        if isinstance(e, A.UnaryOp):
            return self._unary(e)
        if isinstance(e, A.Call):
            return self._call(e)
        if isinstance(e, A.WindowExpr):
            return self._window(e)
        if isinstance(e, A.CaseWhen):
            return self._case(e)
        if isinstance(e, A.Index):
            return self._index(e)
        if isinstance(e, A.Subquery):
            return self._scalar_subquery(e)
        if isinstance(e, A.Star):
            raise EvalError("* not valid in this position")
        raise EvalError(f"cannot evaluate {e!r}")

    # -- subqueries (uncorrelated) -----------------------------------------

    def _run_subquery(self, e: A.Subquery) -> Table:
        # the session's executor: on a mesh it holds the statement's
        # gathered tables
        return self.session.executor.run_select(e.select)

    def _scalar_subquery(self, e: A.Subquery) -> Value:
        t = self._run_subquery(e)
        if len(t.columns) != 1 or t.nrows != 1:
            raise EvalError(f"scalar subquery returned {t.nrows}×"
                            f"{len(t.columns)}, want 1×1")
        col = next(iter(t.columns.values()))
        st = T.StrT if col.sqltype.is_string else col.sqltype
        return Value("scalar", col.to_python()[0], st)

    def _in_subquery(self, e: A.BinOp) -> Value:
        """x IN (SELECT …) in SQL's three-valued logic: true where x
        matches a value, NULL where x is NULL or, where it matches
        nothing, the subquery holds a NULL; else false. NOT x IN (…)
        then keeps no row that is NULL."""
        lv = self.to_row(self.eval(e.left))
        t = self._run_subquery(e.right)
        if len(t.columns) != 1:
            raise EvalError("IN subquery must produce one column")
        col = next(iter(t.columns.values()))
        dev = self.ws.device
        if lv.sqltype.is_string or col.sqltype.is_string:
            if lv.dictionary is None or not col.sqltype.is_string:
                raise EvalError("IN subquery: incompatible string operands")
            # the subquery's strings in the probe's codes; unknown strings
            # (-1) match nothing
            strs = col.to_python()
            vals = torch.tensor([lv.dictionary.lookup(s) for s in strs
                                 if s is not None],
                                dtype=torch.int32, device=dev)
            sub_null = torch.tensor(None in strs, device=dev)
        else:
            vals = col.data[:col.nrows]
            if col.valid is None:
                sub_null = torch.tensor(False, device=dev)
            else:
                ok = col.valid[:col.nrows]
                vals, sub_null = vals[ok], ~ok.all()
        hit = torch.isin(lv.data, vals)
        nulls = ~hit & sub_null
        if lv.nulls is not None:
            hit, nulls = hit & ~lv.nulls, nulls | lv.nulls
        return Value("row", hit, T.BoolT, nulls=nulls)

    # -- binary / unary ----------------------------------------------------

    def _coerce_literal(self, lit: Value, other: Value, op: str) -> Value:
        """A string literal against a date or string column: its day or
        code, or for <, >, <=, >= its lexicographic rank (a half rank
        between neighbours when absent)."""
        if lit.sqltype is T.StrT and isinstance(lit.data, str):
            if other.sqltype.is_temporal:
                return Value("scalar", T.parse_temporal_literal(
                    other.sqltype, lit.data), other.sqltype)
            if other.sqltype.is_string and other.dictionary is not None:
                if op in ("=", "<>"):
                    return Value("scalar",
                                 other.dictionary.lookup(lit.data), T.StrT)
                if op not in ("<", ">", "<=", ">="):
                    return lit          # LIKE patterns stay strings
                strs = sorted(other.dictionary.strings())
                pos = bisect.bisect_left(strs, lit.data)
                rank = float(pos) if pos < len(strs) and strs[pos] == lit.data \
                    else pos - 0.5
                return Value("scalar", rank, T.DoubleT)
        return lit

    def _binop(self, e: A.BinOp) -> Value:
        if e.op == "in" and isinstance(e.right, A.Subquery):
            return self._in_subquery(e)
        lv = self.eval(e.left)
        rv = self.eval(e.right)
        op = e.op
        if isinstance(lv.data, str) or isinstance(rv.data, str):
            if isinstance(lv.data, str) and isinstance(rv.data, str):
                return Value("scalar", _str_compare(op, lv.data, rv.data),
                             T.BoolT)
            if isinstance(lv.data, str):
                lv = self._coerce_literal(lv, rv, op)
            else:
                rv = self._coerce_literal(rv, lv, op)
        if (lv.sqltype.is_string and rv.sqltype.is_string
                and lv.dictionary is not None and rv.dictionary is not None
                and lv.dictionary is not rv.dictionary):
            rv = _translate_codes(rv, lv.dictionary)
        if op in ("<", ">", "<=", ">="):
            lv, rv = _to_ranks(lv), _to_ranks(rv)

        kind = _result_kind(lv.kind, rv.kind)
        if (lv.kind == "scalar" and lv.data is None) or \
                (rv.kind == "scalar" and rv.data is None):
            if op not in ("and", "or"):     # x <op> NULL is NULL
                shape = self._kind_shape(kind)
                t = T.BoolT if op in ("=", "<>", "<", ">", "<=", ">=",
                                      "like") \
                    else T.promote(lv.sqltype, rv.sqltype)
                dev = self.ws.device
                return Value(kind, torch.zeros(shape, dtype=T.torch_dtype(
                    t.np_dtype), device=dev), t,
                    nulls=torch.ones(shape, dtype=torch.bool, device=dev))
        if kind == "row":
            lv, rv = self.to_row(lv), self.to_row(rv)
        a, b = lv.data, rv.data
        nulls = _or_nulls(lv.nulls, rv.nulls)

        if op in ("and", "or"):
            ab, bb = self._as_bool(a), self._as_bool(b)
            if nulls is None:
                return Value(kind, ab & bb if op == "and" else ab | bb,
                             T.BoolT)
            # Kleene: NULL survives only where the other side cannot
            # decide the result
            ta = ab if lv.nulls is None else ab & ~lv.nulls
            fa = ~ab if lv.nulls is None else ~ab & ~lv.nulls
            tb = bb if rv.nulls is None else bb & ~rv.nulls
            fb = ~bb if rv.nulls is None else ~bb & ~rv.nulls
            if op == "and":
                return Value(kind, ta & tb, T.BoolT,
                             nulls=~((ta & tb) | fa | fb))
            return Value(kind, ta | tb, T.BoolT, nulls=~((fa & fb) | ta | tb))
        if op in ("=", "<>", "<", ">", "<=", ">="):
            return Value(kind, fg._binary(op, a, b), T.BoolT, nulls=nulls)
        if op == "like":
            return self._like(lv, rv)
        lt, rt = lv.sqltype, rv.sqltype
        if op in ("+", "-", "*", "%"):
            return Value(kind, fg._binary(op, a, b), T.promote(lt, rt),
                         nulls=nulls)
        if op == "/":
            out_t = T.div_type(lt, rt)
            if isinstance(a, torch.Tensor):
                data = a.to(T.torch_dtype(out_t.np_dtype)) / b
            else:
                data = fg._truediv(a, b)
            return Value(kind, data, out_t, nulls=nulls)
        raise EvalError(f"unknown operator {op}")

    def _as_bool(self, x):
        """x as a bool tensor (a Python value becomes a 0-d one)."""
        if not isinstance(x, torch.Tensor):
            return torch.tensor(bool(x), device=self.ws.device)
        return x if x.dtype == torch.bool else x != 0

    def _like(self, lv: Value, rv: Value) -> Value:
        """LIKE: the pattern is matched against the dictionary on the host,
        giving a per-code lookup table gathered on the device."""
        if not isinstance(rv.data, str):
            raise EvalError("LIKE pattern must be a string literal")
        if lv.kind == "scalar" and isinstance(lv.data, str):
            return Value("scalar", _like_match(lv.data, rv.data), T.BoolT)
        if not (lv.sqltype.is_string and lv.dictionary is not None):
            raise EvalError("LIKE requires a string column")
        pat = re.compile(_like_regex(rv.data))
        lut = torch.tensor([bool(pat.fullmatch(s))
                            for s in lv.dictionary.strings()],
                           dtype=torch.bool, device=self.ws.device)
        if len(lut) == 0:
            return Value(lv.kind, torch.zeros_like(lv.data, dtype=torch.bool),
                         T.BoolT)
        return Value(lv.kind, lut[lv.data.clamp(0, len(lut) - 1).long()],
                     T.BoolT, nulls=lv.nulls)

    def _unary(self, e: A.UnaryOp) -> Value:
        if e.op == "exists" and isinstance(e.operand, A.Subquery):
            return Value("scalar", self._run_subquery(e.operand).nrows > 0,
                         T.BoolT)
        v = self.eval(e.operand)
        if e.op in ("-", "not") and v.kind == "scalar" and v.data is None:
            return v
        if e.op == "-":
            return Value(v.kind, -v.data, v.sqltype, v.dictionary,
                         nulls=v.nulls)
        if e.op == "not":                   # NOT NULL is NULL
            return Value(v.kind, ~self._as_bool(v.data), T.BoolT,
                         nulls=v.nulls)
        if e.op == "missing":               # IS NULL reads the validity
            if v.kind == "scalar":
                return Value("scalar", v.data is None, T.BoolT)
            if v.nulls is not None:
                return Value(v.kind, v.nulls, T.BoolT)
            return Value(v.kind, torch.zeros_like(v.data, dtype=torch.bool),
                         T.BoolT)
        raise EvalError(f"unknown unary {e.op}")

    def _case(self, e: A.CaseWhen) -> Value:
        """Earlier WHENs win: fold from the last WHEN back. A row no WHEN
        takes and with no ELSE is NULL; a NULL condition never matches."""
        acc = self.eval(e.default) if e.default is not None else None
        if acc is not None and acc.kind == "scalar" and acc.data is None:
            acc = None                      # ELSE NULL ≡ no ELSE
        cap = self.ws.capacity
        dev = self.ws.device
        t = None
        for cond, val in reversed(e.whens):
            c = self.to_row(self.eval(cond))
            v = self.to_row(self.eval(val))
            t = v.sqltype if t is None else T.promote(t, v.sqltype)
            sel = self._as_bool(c.data)
            if c.nulls is not None:
                sel = sel & ~c.nulls
            sel = sel.expand(cap) if sel.dim() == 0 else sel
            base = acc.data if acc is not None else 0
            x, base = fg._promote(v.data, base)
            if not isinstance(x, torch.Tensor) \
                    and not isinstance(base, torch.Tensor):
                x = fg._as_rows(x, sel)
            res = torch.where(sel, x, base)
            nulls = None
            if v.nulls is not None or acc is None or acc.nulls is not None:
                none = torch.zeros(cap, dtype=torch.bool, device=dev)
                vn = v.nulls if v.nulls is not None else none
                an = (~none if acc is None
                      else acc.nulls if acc.nulls is not None else none)
                nulls = torch.where(sel, vn, an)
            acc = Value("row", res, t, nulls=nulls)
        return acc if acc is not None else Value("scalar", None, T.DoubleT)

    def _index(self, e: A.Index) -> Value:
        base = self.eval(e.base)
        idx = self.eval(e.index)
        if base.kind == "row" and idx.kind == "scalar":
            return Value("scalar", base.data[int(_host_scalar(idx.data))],
                         base.sqltype, base.dictionary)
        if base.kind == "row":
            iv = self.to_row(idx).data.long()
            return Value("row", base.data[iv.clamp(0, base.data.shape[0] - 1)],
                         base.sqltype, base.dictionary)
        raise EvalError("unsupported indexing")

    # -- calls -------------------------------------------------------------

    def _call(self, e: A.Call) -> Value:
        name = e.func
        udfs = getattr(self.session, "udfs", None)
        if udfs and name in udfs:
            return self._call_udf(udfs[name], e)
        mods = getattr(self.session, "module_functions", None)
        if mods and name in mods:
            from aquery2_tpu_torch.sdk import modules

            return modules.call_module_function(self, mods[name], e.args)
        if name == "count" and (not e.args or isinstance(e.args[0], A.Star)):
            return Value("group", self.group_lens, T.LongT)
        if name in AGG_NAMES:
            return self._call_agg(name, e)
        if name in _RUNNING_NAMES or name in _WINDOW_EXPLICIT:
            return self._call_windowed(name, e)
        if name == "subvec":
            return self._call_subvec(e)
        if name == "pack":
            cols = [self.to_row(self.eval(a)) for a in e.args]
            elem = cols[0].sqltype
            for c in cols[1:]:
                elem = T.promote(elem, c.sqltype)
            return Value("row", cols[0].data, T.VectorT(elem),
                         pack_cols=[c.data for c in cols])
        if name == "missing":
            return self._unary(A.UnaryOp("missing", e.args[0]))
        if name == "pow":
            a, b = self.eval(e.args[0]), self.eval(e.args[1])
            kind = _result_kind(a.kind, b.kind)
            if kind == "row":
                a, b = self.to_row(a), self.to_row(b)
            return Value(kind, torch.pow(self._as_float(a.data), b.data),
                         T.DoubleT)
        if name == "truncate":
            a = self.eval(e.args[0])
            mult = 10.0 ** int(_host_scalar(self.eval(e.args[1]).data))
            return Value(a.kind, torch.round(self._as_float(a.data) * mult)
                         / mult, T.fp_type(a.sqltype))
        if name in _MATH_FNS:
            v = self.eval(e.args[0])
            return Value(v.kind, _MATH_FNS[name](self._as_float(v.data)),
                         T.fp_type(v.sqltype), nulls=v.nulls)
        raise EvalError(f"unknown function {name}")

    def _as_float(self, x):
        """Integers (and Python numbers) to float64; floats stay."""
        if not isinstance(x, torch.Tensor):
            return torch.tensor(float(x), dtype=torch.float64,
                                device=self.ws.device)
        return x if x.is_floating_point() else x.to(torch.float64)

    def _call_agg(self, name: str, e: A.Call) -> Value:
        from aquery2_tpu_torch.engine import grouped_agg

        if name == "distinct_count":
            raise EvalError("distinct_count: write count(DISTINCT x)")
        args = [self.to_row(self.eval(a)) for a in e.args]
        if args and args[0].kind == "scalar":
            return _scalar_agg_fallback(name, args)
        if name not in ("first", "last"):
            # an aggregate skips NULL rows as it skips rows a subvec masks
            args = [v if v.nulls is None else replace(
                v, mask=~v.nulls if v.mask is None else v.mask & ~v.nulls,
                nulls=None) for v in args]
        if e.distinct and name not in ("min", "max"):
            if name not in ("count", "sum", "avg", "mean"):
                raise EvalError(f"{name}(DISTINCT …) is not supported")
            args = [self._distinct_rows(args[0])]
        return grouped_agg.compute(self, name, args)

    def _distinct_rows(self, v: Value) -> Value:
        """v's rows reordered by (group, value), each group's rows staying
        in its span of the group-sorted layout, masked to the first row of
        each run of equal values that the aggregate reads (not NULL, not
        masked): an aggregate of the result reads each group's distinct
        values once."""
        keys = [(self.seg, True, (0, self.G))]
        if v.mask is not None:
            keys.append((~v.mask, True))
        perm, sk = lexsort(keys + [(v.data, True)])
        first = torch.ones_like(sk[-1], dtype=torch.bool)
        first[1:] = (sk[0][1:] != sk[0][:-1]) | fg._differs(sk[-1])
        if v.mask is not None:
            first &= ~sk[1]
        return Value("row", sk[-1], v.sqltype, v.dictionary, mask=first)

    def _call_windowed(self, name: str, e: A.Call) -> Value:
        args = list(e.args)
        w = None
        base = _WINDOW_EXPLICIT.get(name, name)
        if name in _WINDOW_EXPLICIT or (len(args) == 2
                                        and base in scan.WINDOWED):
            # avgs(3, x) is the windowed form, as avgw(3, x)
            w = int(_host_scalar(self.eval(args[0]).data))
            args = args[1:]
        v = self.to_row(self.eval(args[0]))
        if v.kind == "scalar":
            return _scalar_window_fallback(base, v)
        flags = self.flags
        if flags is None and base in ("next", "aggnext"):
            # the last valid row ends the one segment: it keeps its value
            flags = torch.arange(self.ws.capacity,
                                 device=self.ws.device) == self.ws.n
        if w is None:
            data = scan.RUNNING[base](v.data, self.pos, flags)
        else:
            data = scan.WINDOWED[base](w, v.data, self.pos, flags)
        return Value("row", data, scan.result_type(base, v.sqltype),
                     v.dictionary)

    def _call_udf(self, udf, e: A.Call) -> Value:
        args = [self.eval(a) for a in e.args]
        if udf.is_aggregation:
            return udf_mod.run_aggregation_udf(self, udf, args)
        return udf_mod.run_scalar_udf(self, udf, args)

    def _call_subvec(self, e: A.Call) -> Value:
        v = self.to_row(self.eval(e.args[0]))
        a = int(_host_scalar(self.eval(e.args[1]).data))
        b = int(_host_scalar(self.eval(e.args[2]).data))
        mask = (self.pos >= a) & (self.pos < b)
        if v.mask is not None:
            mask = mask & v.mask
        return Value("row", v.data, v.sqltype, v.dictionary, mask=mask)

    # -- SQL window functions (OVER) ---------------------------------------

    def _window_layout(self, e: A.WindowExpr) -> "_Layout":
        """The sorted domain of e's PARTITION BY and ORDER BY, made once
        per query for each distinct pair: one stable lexsort by
        (validity, partition keys, order keys); partitions start where
        the validity or a partition key changes, peer groups where an
        order key also does. A NULL key equals every other NULL (one
        partition, one peer group); a NULL order key sorts first
        ascending and last descending, as ORDER BY sorts it."""
        spec = repr((e.partition_by, e.order_by))
        if spec in self._layouts:
            return self._layouts[spec]
        cap = self.ws.capacity
        dev = self.ws.device
        idx = torch.arange(cap, device=dev)
        keys = [(idx >= self.ws.n, True)]
        part_keys: list[int] = []       # positions in keys, per kind
        order_keys: list[int] = []
        items = [(x, True, part_keys) for x in e.partition_by] + \
            [(o.expr, o.ascending, order_keys) for o in e.order_by]
        for x, asc, into in items:
            v = self._window_value(x)
            d, bounds = self._window_key(x, v)
            if v.nulls is not None:
                into.append(len(keys))
                keys.append((v.nulls, into is part_keys or not asc))
                d = torch.where(v.nulls, torch.zeros((), dtype=d.dtype,
                                                     device=dev), d)
            into.append(len(keys))
            keys.append((d, asc) if bounds is None else (d, asc, bounds))
        perm, sk = lexsort(keys)

        def edges(acc: torch.Tensor, positions) -> torch.Tensor:
            for i in positions:
                acc[1:] |= fg._differs(sk[i])
            return acc

        flags = torch.ones(cap, dtype=torch.bool, device=dev)
        flags[1:] = sk[0][1:] != sk[0][:-1]
        flags = edges(flags, part_keys)
        peer_flags = edges(flags.clone(), order_keys)
        pos = W.positions(flags)
        lay = _Layout(perm, ~sk[0], flags, peer_flags, pos, idx - pos,
                      W.last_index(flags).to(torch.int64))
        self._layouts[spec] = lay
        return lay

    def _window_key(self, x: A.Expr, v: Value):
        """(sort key, (lo, hi) bounds or None) of a window's key value:
        strings by their dictionary rank, bounded by its size; an integer
        column within its (cached) stats, so that the keys pack into
        fewer bits and fewer sorts."""
        if v.sqltype.is_string and v.dictionary is not None:
            return _to_ranks(v).data, (0, max(len(v.dictionary) - 1, 0))
        d = v.data
        if (isinstance(x, A.ColumnRef) and not self.env
                and not d.is_floating_point() and d.dtype != torch.bool):
            return d, self.ws.find(x.name, x.table)[1].stats()
        return d, None

    def _window_value(self, x: A.Expr) -> Value:
        """A window key or argument: one value per row."""
        v = self.to_row(self.eval(x))
        if v.kind != "row":
            raise EvalError(f"window keys and arguments must vary by row: "
                            f"{x}")
        return v

    def _window_arg(self, x: A.Expr, lay: "_Layout"):
        """(Value, its data sorted, its NULL mask sorted or None) of a
        window function's argument."""
        v = self._window_value(x)
        return (v, v.data[lay.perm],
                None if v.nulls is None else v.nulls[lay.perm])

    def _window(self, e: A.WindowExpr) -> Value:
        """fn(...) OVER (PARTITION BY ... ORDER BY ... [frame]): every
        frame computed at once in the sorted domain (_window_layout) by
        the segmented scans of ops/window.py, the results scattered back
        to row order."""
        if self.grouping is not None:
            raise EvalError(
                "window functions over GROUP BY queries are not supported; "
                "wrap the grouped query in a derived table")
        fname = e.func.func
        args = list(e.func.args)
        if e.func.distinct:
            raise EvalError("DISTINCT window aggregates are not supported")
        lay = self._window_layout(e)
        cap = self.ws.capacity
        dev = self.ws.device
        idx = torch.arange(cap, device=dev)
        flags, peer_flags, pos = lay.flags, lay.peer_flags, lay.pos
        start_i, last_i = lay.start, lay.last
        part_len = last_i - start_i + 1

        def out(data_s, sqltype, nulls_s=None, dictionary=None) -> Value:
            return Value("row", lay.unsort(data_s), sqltype, dictionary,
                         nulls=None if nulls_s is None
                         else lay.unsort(nulls_s))

        # ranking functions (no frame)
        if fname in ("row_number", "rank", "dense_rank", "percent_rank",
                     "cume_dist", "ntile"):
            if fname == "row_number":
                return out((pos + 1).to(torch.int64), T.LongT)
            if fname == "dense_rank":
                return out(scan.seg_cumsum(peer_flags.to(torch.int64), flags),
                           T.LongT)
            if fname == "ntile":
                k = int(_host_scalar(self.eval(args[0]).data))
                return out(pos.to(torch.int64) * k
                           // torch.clamp(part_len, min=1) + 1, T.LongT)
            if fname == "cume_dist":
                peer_last = W.last_index(peer_flags).to(torch.int64)
                return out((peer_last - start_i + 1).to(torch.float64)
                           / part_len.to(torch.float64), T.DoubleT)
            peer_first = W.first_index(peer_flags).to(torch.int64)
            if fname == "rank":
                return out(peer_first - start_i + 1, T.LongT)
            rk = (peer_first - start_i).to(torch.float64)
            denom = torch.clamp(part_len - 1, min=1).to(torch.float64)
            return out(torch.where(part_len > 1, rk / denom, 0.0), T.DoubleT)

        # lag / lead
        if fname in ("lag", "lead"):
            v, x_s, n_s = self._window_arg(args[0], lay)
            off = 1
            if len(args) >= 2:
                off = int(_host_scalar(self.eval(args[1]).data))
            default = self.eval(args[2]) if len(args) >= 3 else None
            tgt = idx - off if fname == "lag" else idx + off
            in_part = (tgt >= start_i) & (tgt <= last_i)
            g = tgt.clamp(0, cap - 1)
            data = torch.where(in_part, x_s[g], x_s)
            nulls = torch.zeros(cap, dtype=torch.bool, device=dev) \
                if n_s is None else in_part & n_s[g]
            d = v.dictionary
            if default is not None and default.data is not None:
                dv = default.data
                if v.sqltype.is_string:
                    if not (default.sqltype.is_string and d is not None):
                        raise EvalError("lag/lead default must match type")
                    if d.lookup(str(dv)) < 0:   # the catalog's stays as it is
                        d = StringDict(d.strings())
                    dv = d.encode_one(str(dv))
                data = torch.where(in_part, data, torch.full_like(data, dv))
            else:
                nulls = nulls | ~in_part
            return out(data, v.sqltype, nulls, d)

        # the frame
        lo: int | None
        hi: int | None
        lo_idx = hi_idx = None
        if e.frame is None:
            if e.order_by:
                # the default: RANGE UNBOUNDED PRECEDING .. CURRENT ROW
                lo, hi = None, 0
                hi_idx = W.last_index(peer_flags)
            else:
                lo = hi = None          # the whole partition
        else:
            frame = e.frame

            def bound(b: A.FrameBound, is_start: bool):
                if b.kind in ("unbounded_preceding", "unbounded_following"):
                    return None, None
                if b.kind == "current":
                    if frame.unit == "range":
                        return 0, (W.first_index(peer_flags) if is_start
                                   else W.last_index(peer_flags))
                    return 0, None
                if frame.unit == "range":
                    raise EvalError(
                        "RANGE frames with numeric offsets are not "
                        "supported; use ROWS")
                return (b.offset if b.kind == "following" else -b.offset,
                        None)
            lo, lo_idx = bound(frame.start, True)
            hi, hi_idx = bound(frame.end, False)
            if frame.start.kind == "unbounded_following" or \
                    frame.end.kind == "unbounded_preceding":
                raise EvalError("invalid window frame bounds")
        lo_i, hi_i, empty = W.frame_bounds(start_i, last_i, lo, hi, lo_idx,
                                           hi_idx)

        # first/last/nth value
        if fname in ("first_value", "last_value", "nth_value"):
            v, x_s, n_s = self._window_arg(args[0], lay)
            if fname == "first_value":
                g = lo_i
            elif fname == "last_value":
                g = hi_i
            else:
                k = int(_host_scalar(self.eval(args[1]).data))
                g = lo_i + (k - 1)
                empty = empty | (g > hi_i)
                g = g.clamp(0, cap - 1)
            nulls = empty if n_s is None else n_s[g] | empty
            return out(x_s[g], v.sqltype, nulls, v.dictionary)

        # frame aggregates
        if fname not in ("sum", "avg", "mean", "min", "max", "count", "var",
                         "stddev"):
            raise EvalError(f"unsupported window function {fname}")
        if fname == "count" and (not args or isinstance(args[0], A.Star)):
            return out(torch.where(empty, 0, hi_i - lo_i + 1), T.LongT)

        v, x_s, null_s = self._window_arg(args[0], lay)
        if v.mask is not None:
            m = v.mask[lay.perm]
            null_s = ~m if null_s is None else null_s | ~m
        ind = lay.valid_s if null_s is None else lay.valid_s & ~null_s

        if fname in ("count", "min", "max"):
            C = scan.seg_cumsum(ind.to(torch.int64), flags)
            c = C[hi_i] - C[lo_i] + ind[lo_i].to(torch.int64)
            if fname == "count":
                return out(torch.where(empty, 0, c), T.LongT)
            if lo is not None and hi is not None and not lo <= 0 <= hi:
                raise EvalError(
                    "bounded min/max window frames must include the "
                    "current row")
            op = torch.minimum if fname == "min" else torch.maximum
            is_str = v.sqltype.is_string and v.dictionary is not None
            xv = _to_ranks(replace(v, data=x_s, mask=None, nulls=None)).data \
                if is_str else x_s
            ident = big_of(xv.dtype) if fname == "min" else small_of(xv.dtype)
            xe = torch.where(ind, xv, torch.full((), ident, dtype=xv.dtype,
                                                 device=dev))
            r = W.frame_extreme(xe, flags, pos, lo, hi, op, lo_i, hi_i)
            if is_str and len(v.dictionary):
                # a lexicographic rank back to its code
                code_of_rank = torch.from_numpy(np.argsort(
                    v.dictionary.ranks).astype(np.int32)).to(dev)
                r = code_of_rank[r.clamp(0, len(v.dictionary) - 1).long()]
            return out(r, v.sqltype, empty | (c == 0), v.dictionary)

        xz = torch.where(ind, x_s, torch.zeros((), dtype=x_s.dtype,
                                               device=dev))
        if fname == "sum":
            s, c = W.frame_sum_count(xz, ind, flags, lo_i, hi_i)
            return out(s, T.long_type(v.sqltype), empty | (c == 0))
        s, q, c = W.frame_moments(xz, ind, flags, lo_i, hi_i)
        nulls = empty | (c == 0)
        cs = torch.clamp(c, min=1.0)
        if fname in ("avg", "mean"):
            return out(s / cs, T.DoubleT, nulls)
        varv = torch.clamp(q / cs - (s / cs) ** 2, min=0.0)
        if fname == "var":
            return out(varv, T.DoubleT, nulls)
        return out(torch.sqrt(varv), T.DoubleT, nulls)


# --- helpers --------------------------------------------------------------

def _literal(e: A.Literal) -> Value:
    v = e.value
    if e.is_string:
        return Value("scalar", v, T.StrT)
    if v is None:
        return Value("scalar", None, T.DoubleT)
    if isinstance(v, bool):
        return Value("scalar", v, T.BoolT)
    if isinstance(v, int):
        return Value("scalar", v, T.LongT if abs(v) > 2**31 else T.IntT)
    return Value("scalar", float(v), T.DoubleT)


def _or_nulls(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _result_kind(a: str, b: str) -> str:
    if "row" in (a, b):
        return "row"
    if "group" in (a, b):
        return "group"
    return "scalar"


def _host_scalar(x) -> Any:
    if isinstance(x, torch.Tensor):
        return x.reshape(-1)[0].item()
    return x


def _str_compare(op: str, a: str, b: str) -> bool:
    return {"=": a == b, "<>": a != b, "<": a < b, ">": a > b,
            "<=": a <= b, ">=": a >= b}[op]


def _like_regex(pattern: str) -> str:
    return "".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                   for ch in pattern)


def _like_match(s: str, pattern: str) -> bool:
    return bool(re.fullmatch(_like_regex(pattern), s))


def _ranks(d: StringDict, device) -> torch.Tensor:
    """The dictionary's code → lexicographic rank table on the device."""
    return torch.from_numpy(d.ranks).to(device)


def _to_ranks(v: Value) -> Value:
    """String codes → lexicographic ranks, for ordering comparisons."""
    if not v.sqltype.is_string or v.dictionary is None or v.kind == "scalar":
        return v
    if len(v.dictionary) == 0:
        return Value(v.kind, v.data, T.IntT, mask=v.mask, nulls=v.nulls)
    ranks = _ranks(v.dictionary, v.data.device)
    return Value(v.kind, ranks[v.data.clamp(0, len(ranks) - 1).long()],
                 T.IntT, mask=v.mask, nulls=v.nulls)


def _coalesce(a: Value, b: Value) -> Value:
    """COALESCE(a, b) of two row Values: a where it is not NULL, else b.
    Strings of two dictionaries come out in a new one that holds a's
    strings, in a's codes, and then b's."""
    if a.nulls is None:
        return a
    bdata, d = b.data, a.dictionary
    if (a.sqltype.is_string and d is not None and b.dictionary is not None
            and b.dictionary is not d):
        d = StringDict(d.strings())
        remap = torch.tensor([d.encode_one(s) for s in b.dictionary.strings()]
                             or [0], dtype=torch.int32, device=bdata.device)
        bdata = remap[bdata.clamp(0, remap.shape[0] - 1).long()]
    t = a.sqltype if a.sqltype == b.sqltype else T.promote(a.sqltype,
                                                           b.sqltype)
    dt = torch.promote_types(a.data.dtype, bdata.dtype)
    return Value("row", torch.where(a.nulls, bdata.to(dt), a.data.to(dt)), t,
                 d, nulls=None if b.nulls is None else a.nulls & b.nulls)


def _translate_codes(v: Value, target: StringDict) -> Value:
    """v's string codes re-coded in target's dictionary (-1 where absent)."""
    strs = v.dictionary.strings()
    if not strs:
        return replace(v, dictionary=target)
    codes = [target.lookup(s) for s in strs]
    with sync("strings.translate"):     # a copy to the device, waited on
        remap = torch.tensor(codes, dtype=torch.int32, device=v.data.device)
    return Value(v.kind, remap[v.data.clamp(0, len(strs) - 1).long()],
                 v.sqltype, target, v.mask, nulls=v.nulls)


def _scalar_agg_fallback(name: str, args: list[Value]) -> Value:
    """An aggregate of a scalar: the reference's no-op table
    (aggregations.h:499-527)."""
    v = args[0]
    if name in ("sum", "avg", "mean", "min", "max", "first", "last",
                "median"):
        return v
    if name == "count":
        return Value("scalar", 1, T.LongT)
    if name in ("var", "stddev"):
        return Value("scalar", 0.0, T.DoubleT)
    if name == "corr":
        return Value("scalar", float("nan"), T.DoubleT)
    raise EvalError(f"aggregate {name} of scalar")


def _scalar_window_fallback(name: str, v: Value) -> Value:
    if name in ("deltas", "vars", "stddevs"):
        return Value("scalar", 0, v.sqltype)
    if name == "ratios":
        return Value("scalar", 1.0, T.DoubleT)
    return v
