"""Fused group-by aggregation on torch tensors.

Counterpart of ``aquery2_tpu/engine/fused_groupby.py``: the same plan
(``plan``), the same tier choice (``choose_strategy``), the same limb
split for exact float sums and the same group order, run eagerly on one
device. Two tiers:

  dense   — key domains of at most ``config.ONEHOT_MATMUL_MAX_GROUPS``
            slots: each row's perfect-hash code picks a slot, and the
            onehot_segment_sums kernel sums every add lane per slot in
            int64 (ops/reduce.segment_reduce).
  packed  — keys bit-pack (from column stats) into at most two 30-bit
            words, joined into one int64 sort key: ``torch.sort``, then
            segmented scans over the sorted rows
            (ops/reduce.sorted_group_reduce → the CUDA scan kernels). A
            median argument joins the sort as a secondary key, so each
            group's run is value-ascending and its middle rows are the
            median.

Aggregates: count, sum, avg, min, max, var, stddev, corr (their sums are
ordinary add lanes, so both tiers take them) and median (packed tier).
Groups come out key-ascending in both tiers, as in the JAX package, then
HAVING, ORDER BY (ops/sort.sort_perm) and LIMIT apply. Host syncs: each
key column's stats (cached on the column) and the one compaction that
fixes the group count.

Shapes outside this slice raise NotImplementedError naming the ROADMAP
item that will bring them; a shape the plan does not cover at all
(``Unsupported``) returns None and the executor raises.
"""

from __future__ import annotations

import operator

import torch

from aquery2_tpu_torch import config
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.ops import reduce as R
from aquery2_tpu_torch.ops.sort import canonical_float, sort_perm
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.storage.table import Column, Table
from aquery2_tpu_torch.utils import CaseInsensitiveDict, base62uuid, legal_name

_SIMPLE_AGGS = {"sum", "avg", "mean", "min", "max", "count", "corr",
                "var", "stddev", "median"}
_MATH = {"sqrt": torch.sqrt, "pow": torch.pow, "abs": torch.abs,
         "exp": torch.exp, "log": torch.log, "floor": torch.floor,
         "ceil": torch.ceil, "round": torch.round}
_WORD_BITS = 30          # data bits per packed key word (bit 30 = sentinel)
_SENTINEL = 1 << _WORD_BITS
_LIMB_BITS = 14          # add_float: coarse limb = round(v · 2^14)

_Q3 = "ROADMAP queue 1, item 3 (fused group-by)"


class Unsupported(Exception):
    pass


def _todo(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: {_Q3}")


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
            "expr_keys": expr_keys,
            "into_table": sel.into_table, "into_outfile": sel.into_outfile}


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
    """Sorted lower-cased names of every column the plan touches."""
    refs: set[str] = set()
    for e in [*p["keys"], *(expr for _, expr, _ in p["projections"]),
              p["where"], p["having"]]:
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
      multikey — computed or non-integer keys"""
    key_mins, key_ranges = [], []
    domain = 1
    packable = not p["expr_keys"]
    if packable:
        for k in p["keys"]:
            c = cols[k.name]
            if c.data.dtype.is_floating_point:
                packable = False
                break
            mn, mx = c.stats()
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
    """SQL '/': integer operands divide in float64 (jnp.true_divide)."""
    if not _is_float(a) and not _is_float(b):
        a = a.to(torch.float64) if isinstance(a, torch.Tensor) else float(a)
    return a / b


_BINOPS = {
    "+": operator.add, "-": operator.sub, "*": operator.mul,
    "/": _truediv, "%": operator.mod,
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
            if not isinstance(res, torch.Tensor):
                res = _as_rows(res, c)
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


def _build_lanes(env, valid, scatters):
    """Every aggregate's per-row reduction lanes, masked so invalid rows
    are identities: (add, min, max, f64) dicts of [rows] tensors, as the
    JAX package's _build_lanes. Add lanes hold integers (bool, int32 or
    int64; squares and products of int32 widen to int64 first) and
    ``__counts__``; median rides the sort instead.

    float32 sums split into two integer-valued limbs (the JAX package's
    add_float, P1 = 14) that are summed as int64, so the sums are exact
    and recombine to the JAX package's float64 bit for bit. Sums of other
    float dtypes are float64 lanes."""
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

    def masked(v: torch.Tensor) -> torch.Tensor:
        return torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                 device=v.device))

    def widen_sq(v: torch.Tensor) -> torch.Tensor:
        """A factor of a square or product that cannot overflow."""
        return v.to(torch.int64) if v.element_size() <= 4 else v

    for fp, (kind, args) in scatters.items():
        if kind in ("count", "median"):
            continue            # count rides the counts; median the sort
        if kind == "corr":
            x = _as_rows(_row_eval(args[0], env), valid)
            y = _as_rows(_row_eval(args[1], env), valid)
            if not x.is_floating_point() and not y.is_floating_point():
                xi, yi = masked(x), masked(y)
                xw, yw = widen_sq(xi), widen_sq(yi)
                for tag, arr in (("sx", xi), ("sy", yi), ("sxy", xw * yw),
                                 ("sx2", xw * xw), ("sy2", yw * yw)):
                    add[f"{fp}:{tag}"] = arr
            else:
                xf = masked(x).to(torch.float32)
                yf = masked(y).to(torch.float32)
                for tag, arr in (("sx", xf), ("sy", yf), ("sxy", xf * yf),
                                 ("sx2", xf * xf), ("sy2", yf * yf)):
                    add_float(f"{fp}:{tag}", arr)
            continue
        v = _as_rows(_row_eval(args[0], env), valid)
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
                add[fp + ":ssq"] = vw * vw
        elif kind == "min":
            mins[fp + ":min"] = torch.where(valid, v, R.big_of(v.dtype))
        elif kind == "max":
            maxs[fp + ":max"] = torch.where(valid, v, R.small_of(v.dtype))
    return add, mins, maxs, f64s


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
        if kind == "count":
            return counts.to(torch.int64)
        if kind == "sum":
            return _gathered_sum(dense, fp + ":sum")
        if kind in ("avg", "mean"):
            s = _gathered_sum(dense, fp + ":sum").to(torch.float64)
            return s / torch.clamp(counts, min=1)
        if kind in ("min", "max", "median"):
            return dense[f"{fp}:{kind}"]
        if kind in ("var", "stddev"):
            s = _gathered_sum(dense, fp + ":sum").to(torch.float64)
            ssq = _gathered_sum(dense, fp + ":ssq").to(torch.float64)
            denom = torch.clamp(
                counts.to(torch.float64)
                + (1.0 if config.STRICT_REFERENCE_SEMANTICS else 0.0),
                min=1.0)
            v = (ssq - s * s / denom) / denom
            return torch.sqrt(torch.clamp(v, min=0.0)) if kind == "stddev" \
                else v
        if kind == "corr":
            sx, sy, sxy, sx2, sy2 = (
                _gathered_sum(dense, f"{fp}:{t}").to(torch.float64)
                for t in ("sx", "sy", "sxy", "sx2", "sy2"))
            nn = counts.to(torch.float64)
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

def _check_slice(p, cols, col_order) -> None:
    """Raise NotImplementedError for plans this port does not run yet."""
    if any(cols[nm].valid is not None for nm in col_order if nm in cols):
        raise _todo("nullable columns")
    if p["expr_keys"]:
        raise _todo("computed group keys (the multikey tier)")
    if p["into_table"] or p["into_outfile"]:
        raise NotImplementedError(
            "SELECT INTO: ROADMAP queue 1, item 8 (services)")


def run(sel: A.Select, table: Table) -> Table | None:
    """The fused group-by of ``sel`` over ``table``: the result Table, or
    None when the plan does not cover the statement at all."""
    try:
        p = plan(sel, table)
    except Unsupported:
        return None
    cols = table.columns
    col_order = referenced_columns(p)
    _check_slice(p, cols, col_order)
    n = table.nrows
    if n == 0:
        raise NotImplementedError(
            "group-by of an empty table: ROADMAP queue 1, item 7 "
            "(general engine)")

    chosen = choose_strategy(p, cols)
    if chosen is None:
        return None             # median over keys that do not pack
    strategy, key_mins, key_ranges, domain = chosen
    if strategy == "multikey":
        raise _todo("non-integer group keys (the multikey tier)")
    scatters = _needed_scatters(p["aggs"])
    env = {nm: cols[nm].data for nm in col_order}
    cap = next(iter(env.values())).shape[0]
    valid = torch.arange(cap, device=env[col_order[0]].device) < n
    if p["where"] is not None:
        valid = valid & _truth(_as_rows(_row_eval(p["where"], env), valid))
    key_names = [k.name.lower() for k in p["keys"]]
    if strategy == "dense":
        dense, counts, keyvals = _run_dense(env, valid, scatters, key_names,
                                            key_mins, key_ranges, domain)
    else:
        dense, counts, keyvals = _run_packed(env, valid, scatters, key_names,
                                             key_mins, key_ranges)
    results = []
    for kindp, expr, _alias in p["projections"]:
        if kindp == "key":
            ki = key_names.index(expr.name.lower())
            results.append(keyvals[ki].to(cols[key_names[ki]].data.dtype))
        else:
            results.append(_as_rows(_post_agg_eval(expr, dense, counts),
                                    counts))
    having = (None if p["having"] is None
              else _post_agg_eval(p["having"], dense, counts))
    return _finish(p, cols, results, int(counts.shape[0]), having)


def _run_dense(env, valid, scatters, key_names, key_mins, key_ranges,
               domain):
    """Dense tier: perfect-hash codes index [domain + 1] accumulators;
    present slots compact in code order (= key order)."""
    strides = []
    s = 1
    for r in reversed(key_ranges):
        strides.append(s)
        s *= r
    strides.reverse()
    code = None
    for kn, mn, st in zip(key_names, key_mins, strides):
        part = (env[kn].to(torch.int64) - mn) * st
        code = part if code is None else code + part
    code = torch.where(valid, code, domain).to(torch.int32)
    add, mins, maxs, f64s = _build_lanes(env, valid, scatters)
    outs = R.segment_reduce(code, add, mins, maxs, f64s, domain)
    ucodes = torch.nonzero(outs["__counts__"][:domain] > 0).squeeze(1)
    dense = {t: arr[ucodes] for t, arr in outs.items()}
    keyvals = [(ucodes // st) % r + mn
               for st, r, mn in zip(strides, key_ranges, key_mins)]
    return dense, dense["__counts__"], keyvals


def _run_packed(env, valid, scatters, key_names, key_mins, key_ranges):
    """Packed tier: keys pack into ≤ 2 int32 words of 30-bit fields
    (invalid rows carry the 2^30 sentinel, so they sort behind every
    group), joined into one int64 key (w0 << 31) | w1 and sorted; the
    aggregate-argument columns are gathered by the sort permutation and
    reduced over the sorted runs. A median argument is the sort's second
    key, and each group's median is read at the middle of its run."""
    planned = _plan_words(key_ranges)
    if planned is None:
        raise _todo("keys wider than 30 bits (the multikey tier)")
    fields, nwords = planned
    if nwords > 2:
        raise _todo("keys of more than 2 packed words")
    dev = valid.device
    words = [torch.zeros(valid.shape, dtype=torch.int32, device=dev)
             for _ in range(nwords)]
    for ki, kn in enumerate(key_names):
        wi, shift, _b = fields[ki]
        # in place: ORs each key's field into its word without a temporary
        words[wi] |= ((env[kn].to(torch.int64) - key_mins[ki])
                      .to(torch.int32) << shift)
    words = [torch.where(valid, w, _SENTINEL) for w in words]
    key = words[0].to(torch.int64)
    bound = _SENTINEL
    if nwords == 2:
        key = (key << 31) | words[1].to(torch.int64)
        bound = _SENTINEL << 31
    med_fps = [fp for fp, (kind, _a) in scatters.items() if kind == "median"]
    if med_fps:             # plan() allows one distinct median argument
        mv = _as_rows(_row_eval(scatters[med_fps[0]][1][0], env), valid)
        skey, perm = _median_order(key, mv, nwords == 1)
    else:
        skey, perm = torch.sort(key)
    dif = skey[1:] != skey[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    starts = torch.cat([one, dif])
    last = torch.cat([dif, one]) & (skey < bound)

    argcols: set[str] = set()
    for kind, args in scatters.values():
        for a in args:
            if kind != "median" and not isinstance(a, A.Star):
                argcols |= _refs(a)
    env_s = {nm: env[nm][perm] for nm in argcols}
    add, mins, maxs, f64s = _build_lanes(env_s, skey < bound, scatters)
    add.pop("__counts__")           # counts come from the group ends
    dense, ends = R.sorted_group_reduce(starts, last, add, mins, maxs, f64s,
                                        extract={"__key": skey})
    if med_fps:
        sv = mv[perm]
        first = ends - (dense["__counts__"] - 1)
        dense[med_fps[0] + ":median"] = (
            sv[first + (dense["__counts__"] - 1) // 2].to(torch.float64)
            + sv[first + dense["__counts__"] // 2].to(torch.float64)) * 0.5
    gkey = dense.pop("__key")
    gwords = ([gkey >> 31, gkey & ((1 << 31) - 1)] if nwords == 2
              else [gkey])
    keyvals = []
    for ki in range(len(key_names)):
        wi, shift, b = fields[ki]
        keyvals.append(((gwords[wi] >> shift) & ((1 << b) - 1))
                       + key_mins[ki])
    return dense, dense["__counts__"], keyvals


_PACKS_32 = (torch.float32, torch.int32, torch.int16, torch.int8, torch.uint8,
             torch.bool)     # median arguments whose order fits 32 bits


def _order_bits32(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) ordered as v is (v of a _PACKS_32 dtype); float32
    as canonical_float orders it."""
    if v.is_floating_point():
        b = canonical_float(v).view(torch.int32).to(torch.int64)
        return torch.where(b < 0, ~b, b + (1 << 31))
    return v.to(torch.int64) + (1 << 31)


def _median_order(key: torch.Tensor, v: torch.Tensor, one_word: bool):
    """(sorted key, permutation) ordering rows by key, then by the median
    argument v. With a one-word key (< 2^31) and a 32-bit argument both
    pack into one int64, (key << 32) | order bits of v, and one sort does
    it; otherwise a stable sort by v, then a stable sort by key. Float
    arguments order as ``lax.sort`` orders them: -0.0 ties with 0.0, NaN
    last."""
    if one_word and v.dtype in _PACKS_32:
        skey, perm = torch.sort((key << 32) | _order_bits32(v))
        return skey >> 32, perm
    perm = torch.sort(canonical_float(v) if v.is_floating_point() else v,
                      stable=True).indices
    perm = perm[torch.sort(key[perm], stable=True).indices]
    return key[perm], perm


def _derive_name(e: A.Expr) -> str:
    if isinstance(e, A.ColumnRef):
        return e.name
    if isinstance(e, A.Call):
        inner = "_".join(_derive_name(a) for a in e.args
                         if not isinstance(a, A.Star))
        return legal_name(f"{e.func}_{inner}") if inner else e.func
    if isinstance(e, A.BinOp):
        return legal_name(f"{_derive_name(e.left)}_{e.op}_"
                          f"{_derive_name(e.right)}")
    if isinstance(e, A.Literal):
        return legal_name(str(e.value))
    if isinstance(e, A.UnaryOp):
        return legal_name(f"{e.op}_{_derive_name(e.operand)}")
    return f"col_{base62uuid(4)}"


def _take(t: torch.Tensor | None, idx: torch.Tensor | None,
          k: int) -> torch.Tensor | None:
    if t is None:
        return None
    return t[:k] if idx is None else t[idx]


def _sort_key(p, cols, pi: int, arr: torch.Tensor) -> torch.Tensor:
    """Output column pi's ORDER BY key: string keys by dictionary rank."""
    kindp, expr, _alias = p["projections"][pi]
    if kindp == "key":
        src = cols[expr.name]
        if src.sqltype.is_string and src.dictionary is not None:
            ranks = torch.from_numpy(src.dictionary.ranks).to(arr.device)
            return ranks[arr.to(torch.int64).clamp(0, max(len(ranks) - 1,
                                                          0))]
    return arr


def _finish(p, cols, results, g, having=None) -> Table:
    """The output Table from the per-projection [g] tensors: ``having``
    (an optional [g] group mask) keeps groups, ORDER BY sorts them
    (stable), ``limit`` keeps the first rows."""
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
    used: dict[str, int] = {}
    for (kindp, expr, alias), arr in zip(p["projections"], results):
        name = alias or _derive_name(expr)
        lk = name.lower()
        if lk in used:
            used[lk] += 1
            name = f"{name}_{used[lk]}"
        else:
            used[lk] = 0
        arr = _take(arr, keep, g)
        if kindp == "key":
            src = cols[expr.name]
            out.columns[name] = Column(name, src.sqltype, arr, nrows=g,
                                       dictionary=src.dictionary)
        else:
            st = (T.BoolT if arr.dtype == torch.bool
                  else T.from_np_dtype(T.np_dtype(arr.dtype)))
            out.columns[name] = Column(name, st, arr, nrows=g)
    return out
