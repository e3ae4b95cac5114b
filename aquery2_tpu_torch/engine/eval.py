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

Not here: OVER windows (ROADMAP queue 1, item 7c) and UDF or module calls
(item 7d).
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, replace
from typing import Any

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import fused_groupby as fg
from aquery2_tpu_torch.ops import scan
from aquery2_tpu_torch.ops.sort import lexsort
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.table import StringDict, Table

WINDOWS = "ROADMAP queue 1, item 7c (OVER windows)"


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
                 missing: list[torch.Tensor | None] | None = None) -> None:
        self.sources = sources
        self.indices = indices
        self.n = n
        self.capacity = capacity
        self.device = device
        # per source, True where it contributed no row (an outer join's
        # NULL side): every column of that source reads NULL there
        self.missing = missing if missing is not None \
            else [None] * len(sources)
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
        (source index, VectorColumn)) in schema order, a repeated name (a
        natural join's key) once."""
        out: list[tuple[str, Any]] = []
        seen: set[str] = set()
        for si, (alias, tbl) in enumerate(self.sources):
            if qualifier and qualifier.lower() not in (
                    (alias or "").lower(), tbl.name.lower()):
                continue
            for col in tbl.columns.values():
                if col.name.lower() in seen:
                    continue
                seen.add(col.name.lower())
                if col.is_vector:
                    out.append((col.name, (si, col)))
                else:
                    out.append((col.name, Value(
                        "row", self.gather(si, col), col.sqltype,
                        col.dictionary, nulls=self.gather_nulls(si, col))))
        return out

    def permuted(self, perm: torch.Tensor, new_n: int) -> "WorkingSet":
        """The rows in the order perm gives (len(perm) is the new
        capacity; rows at or past new_n are padding)."""
        idxs = [perm if idx is None else idx[perm.clamp(0, idx.shape[0] - 1)]
                for idx in self.indices]
        miss = [None if m is None else m[perm.clamp(0, m.shape[0] - 1)]
                for m in self.missing]
        return WorkingSet(self.sources, idxs, new_n, int(perm.shape[0]),
                          self.device, missing=miss)


class EvalContext:
    """Evaluation state: the working set, its grouping, the session."""

    def __init__(self, ws: WorkingSet, session=None, grouping=None) -> None:
        self.ws = ws
        self.session = session
        self.grouping = grouping        # rows already permuted by it
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
            return self.ws.column_value(e.name, e.table)
        if isinstance(e, A.BinOp):
            return self._binop(e)
        if isinstance(e, A.UnaryOp):
            return self._unary(e)
        if isinstance(e, A.Call):
            return self._call(e)
        if isinstance(e, A.WindowExpr):
            raise NotImplementedError(f"OVER: {WINDOWS}")
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
        from aquery2_tpu_torch.engine.executor import Executor

        return Executor(self.session).run_select(e.select)

    def _scalar_subquery(self, e: A.Subquery) -> Value:
        t = self._run_subquery(e)
        if len(t.columns) != 1 or t.nrows != 1:
            raise EvalError(f"scalar subquery returned {t.nrows}×"
                            f"{len(t.columns)}, want 1×1")
        col = next(iter(t.columns.values()))
        st = T.StrT if col.sqltype.is_string else col.sqltype
        return Value("scalar", col.to_python()[0], st)

    def _in_subquery(self, e: A.BinOp) -> Value:
        lv = self.to_row(self.eval(e.left))
        t = self._run_subquery(e.right)
        if len(t.columns) != 1:
            raise EvalError("IN subquery must produce one column")
        col = next(iter(t.columns.values()))
        if lv.sqltype.is_string or col.sqltype.is_string:
            if lv.dictionary is None or not col.sqltype.is_string:
                raise EvalError("IN subquery: incompatible string operands")
            # the subquery's strings in the probe's codes; unknown strings
            # (-1) match nothing
            vals = torch.tensor([lv.dictionary.lookup(s)
                                 for s in col.to_python()],
                                dtype=torch.int32, device=self.ws.device)
        else:
            vals = col.data[:col.nrows]
        return Value("row", torch.isin(lv.data, vals), T.BoolT)

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

    def _call_subvec(self, e: A.Call) -> Value:
        v = self.to_row(self.eval(e.args[0]))
        a = int(_host_scalar(self.eval(e.args[1]).data))
        b = int(_host_scalar(self.eval(e.args[2]).data))
        mask = (self.pos >= a) & (self.pos < b)
        if v.mask is not None:
            mask = mask & v.mask
        return Value("row", v.data, v.sqltype, v.dictionary, mask=mask)


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


def _translate_codes(v: Value, target: StringDict) -> Value:
    """v's string codes re-coded in target's dictionary (-1 where absent)."""
    strs = v.dictionary.strings()
    if not strs:
        return replace(v, dictionary=target)
    remap = torch.tensor([target.lookup(s) for s in strs], dtype=torch.int32,
                         device=v.data.device)
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
