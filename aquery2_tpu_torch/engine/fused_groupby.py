"""Fused group-by aggregation on torch tensors.

Counterpart of ``aquery2_tpu/engine/fused_groupby.py``: the same plan
(``plan``), the same tier choice (``choose_strategy``), the same limb
split for exact float sums and the same group order, run eagerly on one
device. Three tiers:

  dense    — key domains of at most ``config.ONEHOT_MATMUL_MAX_GROUPS``
             slots: each row's perfect-hash code picks a slot, and the
             onehot_segment_sums kernel sums every add lane per slot in
             int64 and every float64 lane in float64. Where the plan
             allows (_keyed: integer keys of one dtype, no min or max,
             no nullable argument) the kernel reads the key and argument
             columns as stored and makes the codes, the row validity,
             the products and the counts itself
             (ops/reduce.segment_reduce_keyed); else the tier makes them
             (ops/reduce.segment_reduce).
  packed   — keys bit-pack (from column stats) into 30-bit words: one
             ops/sort.lexsort of [validity, words] (a single int64 sort
             up to two words), then segmented scans over the sorted rows
             (ops/reduce.sorted_group_reduce → the CUDA scan kernels). A
             median argument joins the sort as a secondary key, so each
             group's run is value-ascending and its middle rows are the
             median.
  multikey — computed keys, float keys and integer keys wider than 30
             bits (the JAX package's ``_run_sort``): one lexsort of
             [validity, key values], boundaries where any sorted key or
             the validity changes, the same sorted reduction.

Aggregates: count, sum, avg, min, max, var, stddev, corr (their sums are
ordinary add lanes, so every tier takes them) and median (packed tier).
Groups come out key-ascending in every tier, as in the JAX package, then
HAVING, ORDER BY (ops/sort.sort_perm) and LIMIT apply. Host syncs: each
key column's stats (cached on the column) and the one compaction that
fixes the group count (``groupby.dense.present``, or
``groupby.group_ends`` in ops/reduce). ``run`` names the tier that ran
(the executor counts it in the session's ``tier_runs``) and runs in the
spans ``aq.plan`` (the host work before the first launch, and the
float-sum gate), ``aq.groupby.<tier>`` and ``aq.finish``
(runtime/stats.py).

Nullable columns, as the JAX package runs them: NULL group keys are coded
as (max + 1) in a shallow copy of the table, so they form one group that
sorts last and comes out with its key NULL; NULL aggregate arguments are
skipped, with a per-aggregate non-null count for avg, var, stddev, corr
and count(col). An all-NULL group gets sum 0 and the min/max sentinels,
as in the JAX package. Where the JAX package sends a query to its general
engine instead (an empty table, a nullable WHERE column, a nullable median
argument, Kleene logic inside a nullable argument, a nullable key also
read elsewhere), and for a shape the plan does not cover at all
(``Unsupported``), ``run`` returns None and the executor goes on to the
next tier.
"""

from __future__ import annotations

import operator
import zlib

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops import reduce as R
from aquery2_tpu_torch.ops.segment import last_flags
from aquery2_tpu_torch.ops.sort import lexsort, sort_perm
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.runtime.stats import span, sync
from aquery2_tpu_torch.storage.table import Column, Table
from aquery2_tpu_torch.utils import CaseInsensitiveDict, base62uuid, legal_name

_SIMPLE_AGGS = {"sum", "avg", "mean", "min", "max", "count", "corr",
                "var", "stddev", "median"}
_MATH = {"sqrt": torch.sqrt, "pow": torch.pow, "abs": torch.abs,
         "exp": torch.exp, "log": torch.log, "floor": torch.floor,
         "ceil": torch.ceil, "round": torch.round}
_WORD_BITS = 30          # data bits per packed key word
_LIMB_BITS = 14          # add_float: coarse limb = round(v · 2^14)


class Unsupported(Exception):
    pass


# --------------------------------------------------------------------- #
# plan extraction (the JAX package's rules, unchanged)
# --------------------------------------------------------------------- #

def _check_row_expr(e: A.Expr, cols: CaseInsensitiveDict) -> None:
    if isinstance(e, A.Literal):
        if e.is_string:
            raise Unsupported("string literal in row expr")
        return
    if isinstance(e, A.ColumnRef):
        if e.name not in cols:
            raise Unsupported(f"unknown column {e.name}")
        c = cols[e.name]
        if getattr(c, "is_vector", False) or c.sqltype.is_string:
            raise Unsupported("vector/string column in fused row expr")
        return
    if isinstance(e, A.BinOp) and e.op in ("+", "-", "*", "/", "%", "=",
                                           "<>", "<", ">", "<=", ">=",
                                           "and", "or"):
        _check_row_expr(e.left, cols)
        _check_row_expr(e.right, cols)
        return
    if isinstance(e, A.UnaryOp) and e.op in ("-", "not"):
        _check_row_expr(e.operand, cols)
        return
    if isinstance(e, A.Call) and e.func in _MATH:
        for a in e.args:
            _check_row_expr(a, cols)
        return
    if isinstance(e, A.CaseWhen):
        if e.default is None:
            raise Unsupported("CASE without ELSE (NULL branch)")
        for cond, val in e.whens:
            _check_row_expr(cond, cols)
            _check_row_expr(val, cols)
        _check_row_expr(e.default, cols)
        return
    raise Unsupported(f"row expr {e}")


def _collect_aggs(e: A.Expr, cols, out: list[A.Call]) -> None:
    """Validate a post-agg expression; collect aggregate leaves."""
    if isinstance(e, A.Literal):
        return
    if isinstance(e, A.Call):
        if e.func in _SIMPLE_AGGS:
            if e.distinct:
                raise Unsupported("DISTINCT agg")
            for a in e.args:
                if isinstance(a, A.Star):
                    continue
                _check_row_expr(a, cols)
            out.append(e)
            return
        if e.func == "count" and (not e.args or isinstance(e.args[0], A.Star)):
            out.append(e)
            return
        if e.func in _MATH:
            for a in e.args:
                _collect_aggs(a, cols, out)
            return
        raise Unsupported(f"call {e.func}")
    if isinstance(e, A.BinOp):
        if e.op not in ("+", "-", "*", "/", "%", "=", "<>", "<", ">",
                        "<=", ">=", "and", "or"):
            raise Unsupported(f"post-agg op {e.op}")
        _collect_aggs(e.left, cols, out)
        _collect_aggs(e.right, cols, out)
        return
    if isinstance(e, A.UnaryOp):
        if e.op not in ("-", "not"):
            raise Unsupported(f"post-agg unary {e.op}")
        _collect_aggs(e.operand, cols, out)
        return
    raise Unsupported(f"post-agg expr {e}")


def plan(sel: A.Select, table: Table):
    """Raise Unsupported, or return the fused plan dict."""
    if (not sel.group_by or sel.assumptions or sel.distinct
            or sel.unions):
        raise Unsupported("clause mix")
    if len(sel.sources) != 1 or not isinstance(sel.sources[0], A.TableSource):
        raise Unsupported("joins")
    cols = table.columns

    keys: list[A.Expr] = []
    expr_keys = False
    for g in sel.group_by:
        if isinstance(g, A.ColumnRef) and g.name in cols:
            c = cols[g.name]
            if getattr(c, "is_vector", False):
                raise Unsupported("vector key")
            if c.sqltype.kind == "float":
                # sorts by value in the multikey tier (the JAX package
                # sends a float column key to its general engine)
                keys.append(g)
                expr_keys = True
                continue
            if not (c.sqltype.kind in ("int", "bool") or c.sqltype.is_string
                    or c.sqltype.is_temporal):
                raise Unsupported("non-integer key")
            keys.append(g)
            continue
        _check_row_expr(g, cols)
        keys.append(g)
        expr_keys = True

    if sel.where is not None:
        _check_row_expr(sel.where, cols)

    projections = []
    aggs: list[A.Call] = []
    keyset = {k.name.lower() for k in keys if isinstance(k, A.ColumnRef)}
    for p in sel.projections:
        e = p.expr
        if isinstance(e, A.Star):
            raise Unsupported("star")
        if isinstance(e, A.ColumnRef):
            if e.name.lower() not in keyset:
                raise Unsupported("bare non-key column")
            projections.append(("key", e, p.alias))
            continue
        if any(e == k for k in keys):      # projected computed key
            projections.append(("key", e, p.alias))
            continue
        before = len(aggs)
        _collect_aggs(e, cols, aggs)
        if len(aggs) == before:
            raise Unsupported("projection without aggregate")
        projections.append(("agg", e, p.alias))

    if sel.having is not None:
        _collect_aggs(sel.having, cols, aggs)
    medians = {repr(a.args) for a in aggs if a.func == "median"}
    if len(medians) > 1:
        raise Unsupported("multiple distinct median args")

    order_by: list[tuple[int, bool]] = []
    for item in (sel.order_by or []):
        e = item.expr
        target = None
        for i, pr in enumerate(sel.projections):
            if not isinstance(pr.expr, A.Star) and pr.expr == e:
                target = i
                break
            if (isinstance(e, A.ColumnRef) and e.table is None and pr.alias
                    and pr.alias.lower() == e.name.lower()):
                target = i
                break
        if target is None:
            raise Unsupported("order key is not an output column")
        order_by.append((target, item.ascending))

    return {"keys": keys, "projections": projections, "aggs": aggs,
            "where": sel.where, "limit": sel.limit, "having": sel.having,
            "has_median": bool(medians), "order_by": order_by,
            "expr_keys": expr_keys}


def _refs(e: A.Expr) -> set[str]:
    """Lower-cased column names referenced by an expression."""
    out: set[str] = set()

    def walk(x):
        if isinstance(x, A.ColumnRef):
            out.add(x.name.lower())
        elif isinstance(x, A.BinOp):
            walk(x.left)
            walk(x.right)
        elif isinstance(x, A.UnaryOp):
            walk(x.operand)
        elif isinstance(x, A.Call):
            for a in x.args:
                if not isinstance(a, A.Star):
                    walk(a)
        elif isinstance(x, A.CaseWhen):
            for cond, val in x.whens:
                walk(cond)
                walk(val)
            if x.default is not None:
                walk(x.default)

    walk(e)
    return out


def referenced_columns(p) -> list[str]:
    """Sorted lower-cased names of every column the plan touches (an
    ordered plan's ASSUMING columns included)."""
    refs = {an for an, _asc in p.get("assume", ())}
    for e in [*p["keys"], *(expr for _, expr, _ in p["projections"]),
              p["where"], p.get("having")]:
        if e is not None:
            refs |= _refs(e)
    return sorted(refs)


def _needed_scatters(aggs: list[A.Call]) -> dict[str, tuple]:
    """agg fingerprint → (kind, row exprs). Dedupes identical aggregates."""
    out: dict[str, tuple] = {}
    for call in aggs:
        fp = repr(call)
        if fp not in out:
            out[fp] = (call.func, call.args)
    return out


def choose_strategy(p, cols):
    """(strategy, key_mins, key_ranges, domain) from key stats, or None
    (median without a packable layout), exactly as the JAX package:
      dense    — packable keys whose domain ≤ ONEHOT_MATMUL_MAX_GROUPS
      packed   — other packable keys (integer columns with stats)
      multikey — computed or float keys"""
    key_mins, key_ranges = [], []
    domain = 1
    packable = not p["expr_keys"]
    if packable:
        for k in p["keys"]:
            mn, mx = cols[k.name].stats()
            key_mins.append(int(mn))
            key_ranges.append(int(mx) - int(mn) + 1)
            domain *= key_ranges[-1]
    if p["has_median"]:
        if not packable or _plan_words(key_ranges) is None:
            return None
        strategy = "packed"
    elif packable and domain <= config.ONEHOT_MATMUL_MAX_GROUPS:
        strategy = "dense"
    elif packable:
        strategy = "packed"
    else:
        strategy = "multikey"
    return strategy, key_mins, key_ranges, domain


def _plan_words(key_ranges):
    """Each key's (word, shift, bits) bit-field, declared order, most
    significant first, never straddling a word, so the order of the word
    tuple is the lexicographic order of the keys. (fields, nwords), or
    None if some key needs more than 30 bits."""
    bits = [max(1, (r - 1).bit_length()) for r in key_ranges]
    if any(b > _WORD_BITS for b in bits):
        return None
    words: list[list[int]] = [[]]
    for ki, b in enumerate(bits):
        if sum(bits[i] for i in words[-1]) + b > _WORD_BITS:
            words.append([])
        words[-1].append(ki)
    fields = {}
    for wi, kis in enumerate(words):
        shift = sum(bits[ki] for ki in kis)
        for ki in kis:
            shift -= bits[ki]
            fields[ki] = (wi, shift, bits[ki])
    return fields, len(words)


# --------------------------------------------------------------------- #
# expression evaluation on tensors, with the JAX package's promotions
# --------------------------------------------------------------------- #

def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return isinstance(v, float)


def _promote(a, b):
    """A Python float meeting an integer tensor makes it float64, as a
    weakly-typed float does under JAX's x64 mode (torch would pick
    float32)."""
    if isinstance(a, torch.Tensor) and not a.is_floating_point() \
            and isinstance(b, float):
        a = a.to(torch.float64)
    if isinstance(b, torch.Tensor) and not b.is_floating_point() \
            and isinstance(a, float):
        b = b.to(torch.float64)
    return a, b


def _truth(v):
    if isinstance(v, torch.Tensor):
        return v if v.dtype == torch.bool else v != 0
    return bool(v)


def _truediv(a, b):
    """SQL '/' as jnp.true_divide: integer operands divide in float64 when
    they promote to int64 (a literal beside a bool column does), else in
    float32."""
    if not _is_float(a) and not _is_float(b):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return a / b
        wide = torch.result_type(a, b) == torch.int64
        a = a.to(torch.float64 if wide else torch.float32) \
            if isinstance(a, torch.Tensor) else float(a)
    return a / b


def _mod(a, b):
    """SQL '%' as jnp.mod computes it: the divisor's sign, and 0 where an
    integer divisor is 0 (torch raises there on the CPU; the JAX package
    returns 0)."""
    if _is_float(a) or _is_float(b):
        return a % b
    if isinstance(b, torch.Tensor):
        zero = b == 0
        return torch.where(zero, 0, a % torch.where(zero, 1, b))
    if b == 0:
        return a * 0
    return a % b


_BINOPS = {
    "+": operator.add, "-": operator.sub, "*": operator.mul,
    "/": _truediv, "%": _mod,
    "=": operator.eq, "<>": operator.ne, "<": operator.lt, ">": operator.gt,
    "<=": operator.le, ">=": operator.ge,
    "and": lambda a, b: _truth(a) & _truth(b),
    "or": lambda a, b: _truth(a) | _truth(b),
}


def _binary(op: str, a, b):
    a, b = _promote(a, b)
    return _BINOPS[op](a, b)


def _unary(op: str, v):
    if op == "-":
        return -v
    return torch.logical_not(v) if isinstance(v, torch.Tensor) else not v


def _math(func: str, args):
    """Math calls: a non-float first argument goes to float64."""
    a0 = args[0]
    if not isinstance(a0, torch.Tensor):
        a0 = torch.tensor(float(a0), dtype=torch.float64)
    elif not a0.is_floating_point():
        a0 = a0.to(torch.float64)
    return _MATH[func](a0, *args[1:])


def _row_eval(e: A.Expr, env: dict[str, torch.Tensor]):
    if isinstance(e, A.Literal):
        return e.value
    if isinstance(e, A.ColumnRef):
        return env[e.name.lower()]
    if isinstance(e, A.BinOp):
        return _binary(e.op, _row_eval(e.left, env), _row_eval(e.right, env))
    if isinstance(e, A.UnaryOp):
        return _unary(e.op, _row_eval(e.operand, env))
    if isinstance(e, A.Call) and e.func in _MATH:
        return _math(e.func, [_row_eval(a, env) for a in e.args])
    if isinstance(e, A.CaseWhen) and e.default is not None:
        # earlier WHENs win: fold from the last WHEN backwards
        res = _row_eval(e.default, env)
        for cond, val in reversed(e.whens):
            c = _truth(_row_eval(cond, env))
            v, res = _promote(_row_eval(val, env), res)
            if not isinstance(v, torch.Tensor) \
                    and not isinstance(res, torch.Tensor):
                res = _as_rows(res, c)
            # a Python number beside a tensor takes its dtype, as JAX's
            # weakly typed literals do
            res = torch.where(c, v, res)
        return res
    raise Unsupported(f"trace {e}")


def _as_rows(v, like: torch.Tensor) -> torch.Tensor:
    """A row value as a tensor of like's length (literals broadcast with
    JAX's default dtypes: int64, float64, bool)."""
    if isinstance(v, torch.Tensor):
        return v.expand(like.shape) if v.dim() == 0 else v
    return torch.full(like.shape, v, device=like.device,
                      dtype=torch.bool if isinstance(v, bool)
                      else torch.float64 if isinstance(v, float)
                      else torch.int64)


def _build_lanes(env, valid, scatters, eval_fn=None, null_fn=None,
                 like=None):
    """Every aggregate's per-row reduction lanes, masked so invalid rows
    are identities: (add, min, max, f64) dicts of [rows] tensors, as the
    JAX package's _build_lanes. Add lanes hold integers (bool, int32 or
    int64; squares and products of int32 widen to int64 first) and
    ``__counts__``; median rides the sort instead.

    valid None: the lanes of onehot_segment_sums' keyed form, which drops
    the invalid rows itself (no NULL masks may apply: null_fn None). The
    lanes are not masked, ``__counts__`` is None (the kernel counts each
    slot's rows), an integer product stays the pair of its factors (the
    kernel multiplies them in int64), and ``like``, a column, gives the
    rows' shape.

    float32 sums split into two integer-valued limbs (the JAX package's
    add_float, P1 = 14) that are summed as int64, so the sums are exact
    and recombine to the JAX package's float64 bit for bit. Sums of other
    float dtypes are float64 lanes.

    eval_fn: evaluates an argument expression (default: over ``env``).
    null_fn: arg exprs → [rows] bool, True where a referenced column is
    NULL, or None. SQL aggregates skip NULL inputs: such an aggregate's
    lanes mask those rows too, and it gets a ``:cnt`` lane, its non-null
    count, which avg, var, stddev, corr and count(col) divide by."""
    rows = eval_fn if eval_fn is not None else (lambda e: _row_eval(e, env))
    keyed = valid is None
    like = like if keyed else valid
    add: dict[str, torch.Tensor] = {"__counts__": valid}
    mins: dict[str, torch.Tensor] = {}
    maxs: dict[str, torch.Tensor] = {}
    f64s: dict[str, torch.Tensor] = {}

    def add_float(tag: str, vv: torch.Tensor) -> None:
        if vv.dtype != torch.float32:
            f64s[tag] = vv.to(torch.float64)
            return
        a = torch.round(vv * 2.0 ** _LIMB_BITS)
        r = vv - a * 2.0 ** -_LIMB_BITS
        b = torch.round(r * 2.0 ** (_LIMB_BITS + 24))
        add[tag + "#A"] = a.to(torch.int64)
        add[tag + "#B"] = b.to(torch.int64)

    def widen_sq(v: torch.Tensor) -> torch.Tensor:
        """A factor of a square or product that cannot overflow (the keyed
        form's kernel widens its factors itself)."""
        return v.to(torch.int64) if not keyed and v.element_size() <= 4 \
            else v

    def product(a: torch.Tensor, b: torch.Tensor):
        """a * b, or for the keyed form the pair, which the kernel
        multiplies in int64."""
        return (a, b) if keyed else a * b

    for fp, (kind, args) in scatters.items():
        if kind == "median":
            continue                    # median rides the sort
        nmask = null_fn(args) if null_fn is not None else None
        vm = valid if nmask is None else valid & ~nmask
        if nmask is not None:
            add[fp + ":cnt"] = vm       # the aggregate's non-null count
        if kind == "count":
            continue                    # count(*) rides the counts

        def masked(v: torch.Tensor) -> torch.Tensor:
            if keyed:
                return v
            return torch.where(vm, v, torch.zeros((), dtype=v.dtype,
                                                  device=v.device))

        if kind == "corr":
            x = _as_rows(rows(args[0]), like)
            y = _as_rows(rows(args[1]), like)
            if not x.is_floating_point() and not y.is_floating_point():
                xi, yi = masked(x), masked(y)
                xw, yw = widen_sq(xi), widen_sq(yi)
                for tag, arr in (("sx", xi), ("sy", yi),
                                 ("sxy", product(xw, yw)),
                                 ("sx2", product(xw, xw)),
                                 ("sy2", product(yw, yw))):
                    add[f"{fp}:{tag}"] = arr
            else:
                xf = masked(x).to(torch.float32)
                yf = masked(y).to(torch.float32)
                for tag, arr in (("sx", xf), ("sy", yf), ("sxy", xf * yf),
                                 ("sx2", xf * xf), ("sy2", yf * yf)):
                    add_float(f"{fp}:{tag}", arr)
            continue
        v = _as_rows(rows(args[0]), like)
        if kind in ("sum", "avg", "mean"):
            if v.is_floating_point():
                add_float(fp + ":sum", masked(v))
            else:
                add[fp + ":sum"] = masked(v)
        elif kind in ("var", "stddev"):
            if v.is_floating_point():
                vv = masked(v).to(torch.float32)
                add_float(fp + ":sum", vv)
                add_float(fp + ":ssq", vv * vv)
            else:
                vv = masked(v)
                add[fp + ":sum"] = vv
                vw = widen_sq(vv)
                add[fp + ":ssq"] = product(vw, vw)
        elif kind == "min":
            mins[fp + ":min"] = torch.where(vm, v, R.big_of(v.dtype))
        elif kind == "max":
            maxs[fp + ":max"] = torch.where(vm, v, R.small_of(v.dtype))
    return add, mins, maxs, f64s


_SUM_KINDS = ("sum", "avg", "mean", "var", "stddev", "corr")
_LIMB_LIMIT = 2.0 ** 62     # |Σ limbs| below 2^63, with a factor-2 margin


def float_sums_fit(scatters, cols, n: int, rows, valid,
                   null_fn=None, reduce=None) -> bool:
    """Whether _build_lanes sums every float argument right: no NaN or
    ±inf (a limb split turns them into garbage, and the packed tier's
    float64 running totals carry one into every later group), and for a
    float32 limb lane n · (max |lane| · 2^14 + 1) below 2^62, so the
    int64 limb sums cannot overflow. The lanes are x (sum, avg), x and x²
    (var, stddev, in float32) and x, y, xy, x², y² (corr, in float32 when
    either is a float). Where this is False the caller declines the
    query and the general engine, which sums floats in segmented float64
    scans, answers.

    A stored column's bound is its cached float_summary() (or stats(),
    an integer corr partner); the computed arguments (rows(e) over the
    rows of valid that are not NULL) share one host sync. reduce, where
    given, combines their [args, 2] (not-finite flag, largest |value|)
    over the ranks of a mesh first (an all_reduce max), so that every
    rank decides alike."""
    need: list[tuple[str, list]] = []
    for kind, args in scatters.values():
        if kind in _SUM_KINDS:
            need.append((kind, list(args[:2 if kind == "corr" else 1])))
    if not need:
        return True
    info: dict[str, list] = {}       # repr(e) -> [dtype, source, bound]
    for _kind, exprs in need:
        for e in exprs:
            if repr(e) in info:
                continue
            if isinstance(e, A.ColumnRef) and e.name in cols:
                c = cols[e.name]
                info[repr(e)] = [c.data.dtype, c, None]
                continue
            v = _as_rows(rows(e), valid)
            nm = null_fn([e]) if null_fn is not None else None
            vm = valid if nm is None else valid & ~nm
            info[repr(e)] = [v.dtype, (v, vm), None]

    def wanted(kind, exprs) -> list[str]:
        """The arguments whose bounds this aggregate's lanes need."""
        fl = [info[repr(e)][0].is_floating_point for e in exprs]
        if kind == "corr":
            return [repr(e) for e in exprs] if any(fl) else []
        if not fl[0]:
            return []
        return [repr(exprs[0])]

    pending: dict[str, torch.Tensor] = {}
    for kind, exprs in need:
        for k in wanted(kind, exprs):
            dt, src, _b = info[k]
            if isinstance(src, Column):
                if dt.is_floating_point:
                    info[k][2] = src.float_summary()
                else:
                    mn, mx = src.stats()
                    info[k][2] = (True, float(max(abs(mn), abs(mx))))
            elif k not in pending:
                v, vm = src
                fin = torch.isfinite(v) if v.is_floating_point() \
                    else torch.ones_like(vm)
                mag = torch.where(vm & fin, v.to(torch.float64).abs(), 0)
                pending[k] = torch.stack([
                    (vm & ~fin).any().to(torch.float64),
                    mag.max() if mag.numel() else mag.new_zeros(())])
    if pending:                     # the computed arguments' one sync
        got = torch.stack(list(pending.values()))
        if reduce is not None:
            got = reduce(got)
        with sync("groupby.float_fit"):
            got = got.tolist()
        for k, (bad, mx) in zip(pending, got):
            info[k][2] = (not bad, mx)

    def fits(bound: float) -> bool:
        return n * (bound * 2.0 ** _LIMB_BITS + 1.0) < _LIMB_LIMIT

    for kind, exprs in need:
        ks = wanted(kind, exprs)
        if not ks:
            continue
        if not all(info[k][2][0] for k in ks):
            return False
        m = max(info[k][2][1] for k in ks)
        if kind in ("sum", "avg", "mean"):
            if info[ks[0]][0] == torch.float32 and not fits(m):
                return False
        elif not fits(max(m, m * m)):
            return False
    return True


def _gathered_sum(dense, tag):
    """A sum as float64 from its limbs, or the int64 or float64 sum
    itself."""
    if tag + "#A" in dense:
        return (dense[tag + "#A"].to(torch.float64) * 2.0 ** -_LIMB_BITS
                + dense[tag + "#B"].to(torch.float64)
                * 2.0 ** -(_LIMB_BITS + 24))
    return dense[tag]


def _post_agg_eval(e: A.Expr, dense: dict[str, torch.Tensor], counts):
    """Evaluate a projection over the per-group aggregates."""
    if isinstance(e, A.Literal):
        return e.value
    if isinstance(e, A.Call):
        fp = repr(e)
        kind = e.func
        # the non-null count, where the aggregate's arguments are nullable
        acnt = dense.get(fp + ":cnt", counts)
        if kind == "count":
            return acnt.to(torch.int64)
        if kind == "sum":
            return _gathered_sum(dense, fp + ":sum")
        if kind in ("avg", "mean"):
            s = _gathered_sum(dense, fp + ":sum").to(torch.float64)
            return s / torch.clamp(acnt, min=1)
        if kind in ("min", "max", "median"):
            return dense[f"{fp}:{kind}"]
        if kind in ("var", "stddev"):
            s = _gathered_sum(dense, fp + ":sum").to(torch.float64)
            ssq = _gathered_sum(dense, fp + ":ssq").to(torch.float64)
            denom = torch.clamp(
                acnt.to(torch.float64)
                + (1.0 if config.STRICT_REFERENCE_SEMANTICS else 0.0),
                min=1.0)
            v = (ssq - s * s / denom) / denom
            return torch.sqrt(torch.clamp(v, min=0.0)) if kind == "stddev" \
                else v
        if kind == "corr":
            sx, sy, sxy, sx2, sy2 = (
                _gathered_sum(dense, f"{fp}:{t}").to(torch.float64)
                for t in ("sx", "sy", "sxy", "sx2", "sy2"))
            nn = acnt.to(torch.float64)
            return (nn * sxy - sx * sy) / torch.sqrt(
                (nn * sx2 - sx * sx) * (nn * sy2 - sy * sy))
        if kind in _MATH:
            return _math(kind, [_post_agg_eval(a, dense, counts)
                                for a in e.args])
    if isinstance(e, A.BinOp):
        return _binary(e.op, _post_agg_eval(e.left, dense, counts),
                       _post_agg_eval(e.right, dense, counts))
    if isinstance(e, A.UnaryOp):
        return _unary(e.op, _post_agg_eval(e.operand, dense, counts))
    raise Unsupported(f"post {e}")


# --------------------------------------------------------------------- #
# execution
# --------------------------------------------------------------------- #

def _contains_logical(e: A.Expr) -> bool:
    if isinstance(e, A.BinOp):
        return (e.op in ("and", "or") or _contains_logical(e.left)
                or _contains_logical(e.right))
    if isinstance(e, A.UnaryOp):
        return e.op == "not" or _contains_logical(e.operand)
    if isinstance(e, A.Call):
        return any(_contains_logical(a) for a in e.args
                   if not isinstance(a, A.Star))
    return False


def nullable_gate(p, cols, col_order):
    """(nullable column names, reason | None), as the JAX package's gate.
    The fused tiers run nullable aggregate-argument columns (each lane
    skips its NULL rows, _build_lanes null_fn). A reason means the query
    needs the general engine's three-valued logic: a nullable group key
    (one that sentinel_code_null_keys could not code), a nullable WHERE
    column, a nullable median argument, or and/or inside a nullable
    aggregate argument."""
    nullable = {nm for nm in col_order
                if nm in cols and cols[nm].valid is not None}
    if not nullable:
        return nullable, None
    for k in p["keys"]:
        if _refs(k) & nullable:
            return nullable, "nullable group key"
    if p["where"] is not None and _refs(p["where"]) & nullable:
        return nullable, "nullable WHERE column"
    for kind, args in _needed_scatters(p["aggs"]).values():
        argrefs: set[str] = set()
        for a in args:
            if not isinstance(a, A.Star):
                argrefs |= _refs(a)
        if not argrefs & nullable:
            continue
        if kind == "median":
            return nullable, "nullable median argument"
        if any(_contains_logical(a) for a in args
               if not isinstance(a, A.Star)):
            return nullable, "Kleene logic inside a nullable aggregate argument"
    return nullable, None


def sentinel_code_null_keys(p, table: Table):
    """(table', {key name: sentinel}) with each nullable integer GROUP BY
    key column coded NULL → (non-null max) + 1 in a shallow copy of the
    table, so every tier groups the NULLs together, after every value;
    _finish restores the NULL key. None where that does not apply: no
    nullable column key, a computed key, a non-integer key, a sentinel
    past the dtype's max, or a key column that is also read outside the
    key position (a WHERE or an aggregate needs real NULLs)."""
    cols = table.columns
    key_names = [k.name.lower() for k in p["keys"]
                 if isinstance(k, A.ColumnRef)]
    if len(key_names) != len(p["keys"]):
        return None
    nullable_keys = [kn for kn in key_names
                     if kn in cols and cols[kn].valid is not None]
    if not nullable_keys:
        return None
    other_refs: set[str] = set()
    for kindp, expr, _ in p["projections"]:
        if kindp != "key":
            other_refs |= _refs(expr)
    for e in (p["where"], p["having"]):
        if e is not None:
            other_refs |= _refs(e)
    if other_refs & set(nullable_keys):
        return None

    sents: dict[str, int] = {}
    coded = Table(table.name)
    for c in table.columns.values():
        nm = c.name.lower()
        if nm not in nullable_keys:
            coded.add_column(c)
            continue
        if c.data.is_floating_point() or c.data.dtype == torch.bool:
            return None
        mn, mx = c.stats()
        if mn > mx:                     # all NULL: the stats are sentinels
            mn, mx = 0, 0
        sent = mx + 1
        if sent > torch.iinfo(c.data.dtype).max:
            return None
        nc = Column(c.name, c.sqltype,
                    torch.where(c.valid, c.data, sent).to(c.data.dtype),
                    nrows=c.nrows, dictionary=c.dictionary)
        nc._stats = (mn, sent)
        coded.add_column(nc)
        sents[nm] = sent
    return coded, sents


def make_null_fn(env_null: dict[str, torch.Tensor]):
    """null_fn for _build_lanes: arg exprs → the OR of the referenced
    columns' NULL masks (arithmetic or comparison over NULL is NULL), or
    None when no referenced column is nullable."""
    def nf(args):
        m = None
        for a in args:
            if isinstance(a, A.Star):
                continue
            for nm in _refs(a):
                mask = env_null.get(nm)
                if mask is not None:
                    m = mask if m is None else m | mask
        return m
    return nf


def _key_index(keys: list[A.Expr], expr: A.Expr) -> int:
    """Index of a projected key in the GROUP BY list: by name for column
    references, by AST equality for computed keys."""
    for i, k in enumerate(keys):
        if k == expr or (isinstance(k, A.ColumnRef)
                         and isinstance(expr, A.ColumnRef)
                         and k.name.lower() == expr.name.lower()):
            return i
    raise Unsupported(f"projection {expr} is not a group key")


def run(sel: A.Select, table: Table) -> tuple[str, Table] | None:
    """The fused group-by of ``sel`` over ``table``: (the tier that ran it,
    "dense", "packed" or "sort" (the multikey tier, or keys wider than 30
    bits); the result Table), or None when the plan does not cover the
    statement at all."""
    with span("plan"):
        try:
            p = plan(sel, table)
        except Unsupported:
            return None
        n = table.nrows
        if n == 0:
            return None
        sub = sentinel_code_null_keys(p, table)
        if sub is not None:
            table, p["key_sentinels"] = sub
        cols = table.columns

        chosen = choose_strategy(p, cols)
        if chosen is None:
            return None             # median over keys that do not pack
        strategy, key_mins, key_ranges, domain = chosen
        col_order = referenced_columns(p)
        nullable, bail = nullable_gate(p, cols, col_order)
        if bail:
            return None
        scatters = _needed_scatters(p["aggs"])
    env = {nm: cols[nm].data for nm in col_order}
    env_null = {nm: ~cols[nm].valid for nm in sorted(nullable)}
    null_fn = make_null_fn(env_null) if env_null else None
    keys = p["keys"]
    keyed = strategy == "dense" and _keyed(keys, env, scatters, null_fn)
    like = env[col_order[0]]
    where = None if p["where"] is None else \
        _truth(_as_rows(_row_eval(p["where"], env), like))
    valid = None            # the keyed form drops invalid rows itself
    if not keyed or _computed_sum_args(scatters, cols):
        valid = torch.arange(like.shape[0], device=like.device) < n
        if where is not None:
            valid = valid & where
    with span("plan"):
        fits = float_sums_fit(scatters, cols, n, lambda e: _row_eval(e, env),
                              valid, null_fn)
    if not fits:
        return None
    if keyed:
        tier = "dense"
        with span("groupby.dense"):
            dense, counts, keyvals = _run_dense_keyed(env, n, where, scatters,
                                                      keys, key_mins,
                                                      key_ranges, domain)
    elif strategy == "dense":
        tier = "dense"
        with span("groupby.dense"):
            dense, counts, keyvals = _run_dense(env, env_null, valid,
                                                scatters, keys, key_mins,
                                                key_ranges, domain)
    elif strategy == "packed" and _plan_words(key_ranges) is not None:
        tier = "packed"
        with span("groupby.packed"):
            dense, counts, keyvals = _run_packed(env, env_null, valid,
                                                 scatters, keys, key_mins,
                                                 key_ranges)
    else:                       # multikey, or a key wider than 30 bits
        # integer column keys wider than 30 bits sort within their stats
        # bounds; computed and float keys (no key_mins) by value
        tier = "sort"
        bounds = ([(mn, mn + r - 1) for mn, r in zip(key_mins, key_ranges)]
                  or [None] * len(keys))
        with span("groupby.sort"):
            dense, counts, keyvals = _run_sort(env, env_null, valid,
                                               scatters, keys, bounds)
    with span("finish"):
        return tier, finish_groups(p, cols, dense, counts, keyvals)


def finish_groups(p, cols, dense, counts, keyvals) -> Table:
    """The output Table from the per-group lanes (``dense``, tag → [g]),
    the group sizes and each key's [g] values, groups in key order: the
    projections, then HAVING, ORDER BY and LIMIT (_finish)."""
    keys = p["keys"]
    results = []
    for kindp, expr, _alias in p["projections"]:
        if kindp == "key":
            kv = keyvals[_key_index(keys, expr)]
            if isinstance(expr, A.ColumnRef):
                kv = kv.to(cols[expr.name].data.dtype)
            results.append(kv)
        else:
            results.append(_as_rows(_post_agg_eval(expr, dense, counts),
                                    counts))
    having = (None if p["having"] is None
              else _post_agg_eval(p["having"], dense, counts))
    return _finish(p, cols, results, int(counts.shape[0]), having)


def _keyed(keys, env, scatters, null_fn) -> bool:
    """Whether the dense tier takes onehot_segment_sums' keyed form, which
    reads the key and argument columns as they are stored: the keys
    integer columns of one dtype (sentinel-coded NULL keys too), no min
    or max lane (scatter_reduce_ takes the slot codes) and no NULL mask
    on an aggregate's arguments (masked values and ``:cnt`` lanes are per
    lane). Other plans take the code form."""
    dtypes = {env[k.name.lower()].dtype for k in keys}
    if (len(dtypes) != 1 or len(keys) > K.ONEHOT_MAX_KEYS
            or dtypes.pop() not in K.ONEHOT_KEY_DTYPES):
        return False
    return not any(kind in ("min", "max")
                   or (null_fn is not None and null_fn(args) is not None)
                   for kind, args in scatters.values())


def _computed_sum_args(scatters, cols) -> bool:
    """Whether float_sums_fit evaluates an argument over the valid rows: a
    sum's argument that is not a stored column."""
    return any(not (isinstance(e, A.ColumnRef) and e.name in cols)
               for kind, args in scatters.values() if kind in _SUM_KINDS
               for e in args[:2 if kind == "corr" else 1])


def _dense_strides(key_ranges) -> list[int]:
    """Each key's stride in the perfect-hash code: the product of the
    ranges of the keys after it."""
    strides = []
    s = 1
    for r in reversed(key_ranges):
        strides.append(s)
        s *= r
    return strides[::-1]


def _dense_groups(outs, domain, strides, key_ranges, key_mins):
    """The present slots (count > 0) compacted in code order (= key order):
    (per-group lanes, counts, each key's values)."""
    with sync("groupby.dense.present"):
        ucodes = torch.nonzero(outs["__counts__"][:domain] > 0).squeeze(1)
    dense = {t: arr[ucodes] for t, arr in outs.items()}
    keyvals = [(ucodes // st) % r + mn
               for st, r, mn in zip(strides, key_ranges, key_mins)]
    return dense, dense["__counts__"], keyvals


def _run_dense(env, env_null, valid, scatters, keys, key_mins, key_ranges,
               domain):
    """Dense tier, code form: perfect-hash codes index [domain + 1]
    accumulators, invalid rows the last; present slots compact in code
    order (= key order)."""
    strides = _dense_strides(key_ranges)
    code = None
    for k, mn, st in zip(keys, key_mins, strides):
        part = (env[k.name.lower()].to(torch.int64) - mn) * st
        code = part if code is None else code + part
    code = torch.where(valid, code, domain).to(torch.int32)
    add, mins, maxs, f64s = _build_lanes(
        env, valid, scatters, null_fn=make_null_fn(env_null) if env_null
        else None)
    outs = R.segment_reduce(code, add, mins, maxs, f64s, domain)
    return _dense_groups(outs, domain, strides, key_ranges, key_mins)


def _run_dense_keyed(env, n, where, scatters, keys, key_mins, key_ranges,
                     domain):
    """Dense tier, keyed form (_keyed): onehot_segment_sums reads rows
    [0, n) of the key and argument columns as stored, makes each row's
    code, drops the rows where ``where`` is False and counts each slot's
    rows; present slots compact in code order (= key order)."""
    strides = _dense_strides(key_ranges)
    key_cols = [env[k.name.lower()] for k in keys]
    add, _mins, _maxs, f64s = _build_lanes(env, None, scatters,
                                           like=key_cols[0])
    outs = R.segment_reduce_keyed(key_cols, key_mins, strides, where, n, add,
                                  f64s, domain)
    return _dense_groups(outs, domain, strides, key_ranges, key_mins)


def _sorted_lanes(env, env_null, perm, valid_s, scatters):
    """The reduction lanes over sorted rows: the aggregate-argument
    columns and their NULL masks gathered by the sort permutation."""
    argcols: set[str] = set()
    for kind, args in scatters.values():
        for a in args:
            if kind != "median" and not isinstance(a, A.Star):
                argcols |= _refs(a)
    env_s = {nm: env[nm][perm] for nm in argcols}
    null_s = {nm: m[perm] for nm, m in env_null.items() if nm in argcols}
    return _build_lanes(env_s, valid_s, scatters,
                        null_fn=make_null_fn(null_s) if null_s else None)


def _differs(sk: torch.Tensor) -> torch.Tensor:
    """[n - 1] bool: row i + 1's sorted key differs from row i's. NaN keys
    are equal to each other, so they make one group (the sort puts them
    together, last), and -0.0 equals 0.0."""
    d = sk[1:] != sk[:-1]
    if sk.is_floating_point():
        d &= ~(sk[1:].isnan() & sk[:-1].isnan())
    return d


def sorted_groups(valid, keys, order_keys=()):
    """One stable lexsort of [invalid, keys..., order_keys...], validity
    most significant, so invalid rows sort behind every valid group
    whatever their key values. keys and order_keys are lexsort entries
    (tensor, ascending[, (lo, hi)]); order_keys only order the rows within
    a group. Returns (perm, valid_s, the sorted keys and order keys,
    starts, last): a group starts where the validity or any key changes,
    and ``last`` flags each valid group's last row."""
    perm, sk = lexsort([(~valid, True), *keys, *order_keys])
    valid_s = ~sk[0]
    dif = sk[0][1:] != sk[0][:-1]
    for x in sk[1:1 + len(keys)]:
        dif |= _differs(x)
    one = torch.ones(1, dtype=torch.bool, device=valid.device)
    starts = torch.cat([one, dif])
    return perm, valid_s, sk[1:], starts, last_flags(starts) & valid_s


def word_bounds(fields, nwords):
    """Each key word's (lo, hi) for lexsort: (0, 2^used - 1), used the bits
    _plan_words gave its fields, so that the sort runs over those bits."""
    used = [1] * nwords
    for wi, shift, bits in fields.values():
        used[wi] = max(used[wi], shift + bits)
    return [(0, (1 << u) - 1) for u in used]


def _run_packed(env, env_null, valid, scatters, keys, key_mins, key_ranges):
    """Packed tier: keys pack into int32 words of fields of at most 30
    bits, sorted by sorted_groups over the bits the words use (word_bounds;
    the validity bit and the words pack into as few sorts as fit). The
    aggregate-argument columns are gathered by the sort permutation and
    reduced over the sorted runs (reduce_sorted_runs)."""
    fields, nwords = _plan_words(key_ranges)
    dev = valid.device
    words = [torch.zeros(valid.shape, dtype=torch.int32, device=dev)
             for _ in range(nwords)]
    for ki, k in enumerate(keys):
        wi, shift, _b = fields[ki]
        # in place: ORs each key's field into its word without a temporary
        words[wi] |= ((env[k.name.lower()].to(torch.int64) - key_mins[ki])
                      .to(torch.int32) << shift)
    dense, counts, gwords = reduce_sorted_runs(
        env, env_null, valid, scatters,
        [(w, True, b) for w, b in zip(words, word_bounds(fields, nwords))])
    keyvals = []
    for ki in range(len(keys)):
        wi, shift, b = fields[ki]
        keyvals.append(((gwords[wi] >> shift) & ((1 << b) - 1))
                       + key_mins[ki])
    return dense, counts, keyvals


def _run_sort(env, env_null, valid, scatters, keys, bounds):
    """Multikey tier (the JAX package's _run_sort): reduce_sorted_runs over
    the key values; each group's keys are read at its last row. bounds:
    each key's (min, max) from column stats, or None (computed or float
    keys)."""
    kv = [_as_rows(_row_eval(k, env), valid) for k in keys]
    return reduce_sorted_runs(env, env_null, valid, scatters,
                              [(v, True) if b is None else (v, True, b)
                               for v, b in zip(kv, bounds)])


def reduce_sorted_runs(env, env_null, valid, scatters, entries):
    """The sort tiers' reduction: sorted_groups over the key entries
    (lexsort entries), the aggregate-argument columns gathered by the
    permutation and reduced over the runs. A median argument is the
    sort's order key, so each group's run is value-ascending and its
    median is read at the middle of the run. (per-group lanes, group
    sizes, each entry's [g] values at the group ends)."""
    med_fps = [fp for fp, (kind, _a) in scatters.items() if kind == "median"]
    med = []
    if med_fps:             # plan() allows one distinct median argument
        mv = _as_rows(_row_eval(scatters[med_fps[0]][1][0], env), valid)
        med = [(mv, True)]
    perm, valid_s, sk, starts, last = sorted_groups(valid, entries, med)
    add, mins, maxs, f64s = _sorted_lanes(env, env_null, perm, valid_s,
                                          scatters)
    nk = len(entries)
    dense, ends = R.sorted_group_reduce(
        starts, last, add, mins, maxs, f64s,
        extract={f"__key{i}": x for i, x in enumerate(sk[:nk])},
        counts_from_ends="__counts__")
    counts = dense["__counts__"]
    if med_fps:
        sv = sk[nk]
        first = ends - (counts - 1)
        dense[med_fps[0] + ":median"] = (
            sv[first + (counts - 1) // 2].to(torch.float64)
            + sv[first + counts // 2].to(torch.float64)) * 0.5
    return dense, counts, [dense.pop(f"__key{i}") for i in range(nk)]


def derive_name(e: A.Expr) -> str:
    """The output name of an unaliased projection of ``e``."""
    if isinstance(e, A.ColumnRef):
        return e.name
    if isinstance(e, A.Call):
        inner = "_".join(derive_name(a) for a in e.args
                         if not isinstance(a, A.Star))
        return legal_name(f"{e.func}_{inner}") if inner else e.func
    if isinstance(e, A.BinOp):
        return legal_name(f"{derive_name(e.left)}_{e.op}_"
                          f"{derive_name(e.right)}")
    if isinstance(e, A.Literal):
        return legal_name(str(e.value))
    if isinstance(e, A.UnaryOp):
        return legal_name(f"{e.op}_{derive_name(e.operand)}")
    # named after the expression's text, so that every rank of a mesh
    # (and every run) names it alike
    return f"col_{zlib.crc32(repr(e).encode()):08x}"


def output_names(projections) -> list[str]:
    """Each projection's output name: its alias or a name derived from
    the expression, a repeat suffixed _1, _2, ... (case-insensitively)."""
    used: dict[str, int] = {}
    names = []
    for _kindp, expr, alias in projections:
        name = alias or derive_name(expr)
        lk = name.lower()
        if lk in used:
            used[lk] += 1
            name = f"{name}_{used[lk]}"
        else:
            used[lk] = 0
        names.append(name)
    return names


def sql_type(arr: torch.Tensor) -> T.SQLType:
    """The SQL type of a computed column from its dtype."""
    return T.BoolT if arr.dtype == torch.bool \
        else T.from_np_dtype(T.np_dtype(arr.dtype))


def _take(t: torch.Tensor | None, idx: torch.Tensor | None,
          k: int) -> torch.Tensor | None:
    if t is None:
        return None
    return t[:k] if idx is None else t[idx]


def _sort_key(p, cols, pi: int, arr: torch.Tensor) -> torch.Tensor:
    """Output column pi's ORDER BY key: string keys by dictionary rank, a
    sentinel-coded NULL key as the dtype's minimum (NULLs first ascending,
    as the JAX package orders the output column)."""
    kindp, expr, _alias = p["projections"][pi]
    if kindp == "key" and isinstance(expr, A.ColumnRef):
        src = cols[expr.name]
        sent = (p.get("key_sentinels") or {}).get(expr.name.lower())
        null = None if sent is None else arr == sent
        if src.sqltype.is_string and src.dictionary is not None:
            ranks = torch.from_numpy(src.dictionary.ranks).to(arr.device)
            arr = ranks[arr.to(torch.int64).clamp(0, max(len(ranks) - 1, 0))]
        if null is not None:
            arr = torch.where(null, torch.iinfo(arr.dtype).min, arr)
    return arr


def _finish(p, cols, results, g, having=None) -> Table:
    """The output Table from the per-projection [g] tensors: ``having``
    (an optional [g] group mask) keeps groups, ORDER BY sorts them
    (stable), ``limit`` keeps the first rows. A sentinel-coded key column
    (sentinel_code_null_keys) gets its NULL back."""
    keep = None
    if having is not None:
        keep = torch.nonzero(_truth(_as_rows(having, results[0]))).squeeze(1)
        g = int(keep.shape[0])
    if p["order_by"] and g:
        perm = sort_perm([(_sort_key(p, cols, pi, _take(results[pi], keep, g)),
                           asc) for pi, asc in p["order_by"]], g)
        keep = perm if keep is None else keep[perm]
    if p["limit"] is not None and p["limit"] < g:
        keep = (torch.arange(p["limit"], device=results[0].device)
                if keep is None else keep[:p["limit"]])
        g = p["limit"]

    out = Table(f"result_{base62uuid(4)}")
    sents = p.get("key_sentinels") or {}
    names = output_names(p["projections"])
    for (kindp, expr, _alias), name, arr in zip(p["projections"], names,
                                                results):
        arr = _take(arr, keep, g)
        if kindp == "key" and isinstance(expr, A.ColumnRef):
            src = cols[expr.name]
            valid = None
            sent = sents.get(expr.name.lower())
            if sent is not None:            # restore the NULL-group key
                valid = arr != sent
                arr = torch.where(valid, arr, torch.zeros_like(arr))
            out.columns[name] = Column(name, src.sqltype, arr, nrows=g,
                                       dictionary=src.dictionary,
                                       valid=valid)
        else:
            out.columns[name] = Column(name, sql_type(arr), arr, nrows=g)
    return out
