"""Fused ordered group-by: the AQuery time-series signature.

Counterpart of ``aquery2_tpu/engine/fused_ordered.py``:

    SELECT key..., wexpr..., agg(wexpr)...
    FROM t [ASSUMING ASC/DESC cols] [WHERE rowpred]
    GROUP BY keys

e.g. trades q7  ``SELECT sym, avgs(5, price) ... ASSUMING ASC time GROUP BY sym``
     trades q10 ``SELECT sym, MAX(stddevs(3, price)) ... GROUP BY sym``
     h2o q8     ``SELECT id6, subvec(v3, 0, 2) ... ASSUMING DESC v3 GROUP BY id6``

The same plan as the JAX package, run eagerly on one device:

  1. validity (and WHERE) mask;
  2. fused_groupby.sorted_groups: one stable ops/sort.lexsort of
     [invalid, group keys..., ASSUMING columns...], group-major,
     ASSUMING-ordered within each group, ties in insertion order (AQuery's
     rule), so no row-index key is needed, and the boundary flags where
     the validity or a key changes (the multikey tier's rule). Key and
     ASSUMING columns come back from the sort; the other referenced
     columns are gathered by its permutation;
  3. each row's position in its group (ops/segment.pos_from_flags, a
     seg_scan_multi launch);
  4. windowed and running expressions through ops/scan.py;
  5. aggregates through ops/reduce.sorted_group_reduce, the lanes built
     by fused_groupby._build_lanes over the sorted layout;
  6. per-group scalars, and ragged per-row values as VectorColumns: every
     row of the group, or for subvec(x, a, b) the rows at positions
     [a, b) of each group, kept by one order-preserving mask compaction,
     with per-group kept counts in closed form.

Valid rows sort first, so the boundary flags also end the last valid group
where the invalid rows begin: ``next`` keeps that group's last value (the
JAX package flags only valid rows, and there reads the first invalid row).
A shape the plan does not cover, an empty table and nullable columns
return None, for the general engine (engine/executor.py), as in the JAX
package; so do ungrouped ordered queries and ordered ones with HAVING,
ORDER BY or LIMIT. Steps 2-6 are ``ordered_groups``, which each rank of
a mesh also runs over its complete groups (engine/dist_ordered.py), with
the NULL masks of nullable aggregate arguments.
"""

from __future__ import annotations

import torch

from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import fused_groupby as fg
from aquery2_tpu_torch.ops import reduce as R
from aquery2_tpu_torch.ops import scan as S
from aquery2_tpu_torch.ops.segment import pos_from_flags
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.runtime.stats import span, sync
from aquery2_tpu_torch.storage.table import Column, Table, VectorColumn
from aquery2_tpu_torch.utils import base62uuid

_WINDOW_NAMES = set(S.RUNNING) | set(S.WINDOWED) | {"subvec"}
_W_SUFFIXED = {"sumw": "sums", "avgw": "avgs", "minw": "mins",
               "maxw": "maxs", "varw": "vars", "stddevw": "stddevs",
               "ratiow": "ratios"}


class Unsupported(fg.Unsupported):
    pass


# --------------------------------------------------------------------- #
# planning (the JAX package's rules, unchanged)
# --------------------------------------------------------------------- #

def _is_window_call(e: A.Expr) -> bool:
    return isinstance(e, A.Call) and e.func in _WINDOW_NAMES


def _contains_window(e: A.Expr) -> bool:
    if _is_window_call(e):
        return True
    if isinstance(e, A.BinOp):
        return _contains_window(e.left) or _contains_window(e.right)
    if isinstance(e, A.UnaryOp):
        return _contains_window(e.operand)
    if isinstance(e, A.Call):
        return any(_contains_window(a) for a in e.args
                   if not isinstance(a, A.Star))
    return False


def _check_ordered_row_expr(e: A.Expr, cols) -> None:
    """Row expr possibly containing windowed calls."""
    if isinstance(e, A.Call) and e.func in _WINDOW_NAMES:
        args = list(e.args)
        if e.func == "subvec":
            if len(args) != 3:
                raise Unsupported("subvec arity")
            _check_ordered_row_expr(args[0], cols)
            for a in args[1:]:
                if not isinstance(a, A.Literal):
                    raise Unsupported("subvec bounds must be literals")
            return
        if len(args) == 2:
            if not isinstance(args[0], A.Literal):
                raise Unsupported("window size must be a literal")
            args = args[1:]
        for a in args:
            _check_ordered_row_expr(a, cols)
        return
    if isinstance(e, A.Call) and e.func in fg._MATH:
        for a in e.args:
            _check_ordered_row_expr(a, cols)
        return
    if isinstance(e, A.BinOp):
        _check_ordered_row_expr(e.left, cols)
        _check_ordered_row_expr(e.right, cols)
        return
    if isinstance(e, A.UnaryOp):
        _check_ordered_row_expr(e.operand, cols)
        return
    fg._check_row_expr(e, cols)


def plan(sel: A.Select, table: Table):
    if (sel.having or sel.distinct or sel.unions or sel.order_by
            or sel.limit is not None):
        raise Unsupported("clause mix")
    if len(sel.sources) != 1 or not isinstance(sel.sources[0], A.TableSource):
        raise Unsupported("joins")
    if not sel.group_by:
        raise Unsupported("ungrouped ordered queries use the general path")
    cols = table.columns

    any_window = False
    keys: list[A.ColumnRef] = []
    for g in sel.group_by:
        if not isinstance(g, A.ColumnRef) or g.name not in cols:
            raise Unsupported("non-column group key")
        c = cols[g.name]
        if getattr(c, "is_vector", False):
            raise Unsupported("vector key")
        if not (c.sqltype.kind in ("int", "bool") or c.sqltype.is_string
                or c.sqltype.is_temporal):
            raise Unsupported("non-integer key")
        keys.append(g)

    assume: list[tuple[str, bool]] = []
    for a in sel.assumptions:
        if a.col.name not in cols:
            raise Unsupported("unknown assumption column")
        c = cols[a.col.name]
        if getattr(c, "is_vector", False) or c.sqltype.is_string:
            raise Unsupported("string/vector assumption column")
        assume.append((a.col.name.lower(), a.ascending))

    if sel.where is not None:
        fg._check_row_expr(sel.where, cols)

    projections = []   # (kind, expr, alias): 'key' | 'row' | 'agg'
    aggs: list[A.Call] = []
    keyset = {k.name.lower() for k in keys}
    for p in sel.projections:
        e = p.expr
        if isinstance(e, A.Star):
            raise Unsupported("star")
        if isinstance(e, A.ColumnRef):
            if e.name.lower() not in keyset:
                raise Unsupported("bare non-key column (general path handles)")
            projections.append(("key", e, p.alias))
            continue
        if _contains_window(e) and not _agg_on_top(e):
            _check_ordered_row_expr(e, cols)
            any_window = True
            projections.append(("row", e, p.alias))
            continue
        before = len(aggs)
        _collect_ordered_aggs(e, cols, aggs)
        if len(aggs) == before:
            raise Unsupported("projection without aggregate")
        if any(_contains_window(a) for call in aggs[before:]
               for a in call.args if not isinstance(a, A.Star)):
            any_window = True
        projections.append(("agg", e, p.alias))
    if not any_window and not assume:
        raise Unsupported("no ordered features — plain fused path handles")
    return {"keys": keys, "assume": assume, "projections": projections,
            "aggs": aggs, "where": sel.where}


def _agg_on_top(e: A.Expr) -> bool:
    return isinstance(e, A.Call) and e.func in fg._SIMPLE_AGGS


def _collect_ordered_aggs(e: A.Expr, cols, out: list[A.Call]) -> None:
    if isinstance(e, A.Literal):
        return
    if isinstance(e, A.Call):
        if e.func in fg._SIMPLE_AGGS:
            if e.func == "median":
                raise Unsupported("median needs the packed-sort layout")
            for a in e.args:
                if not isinstance(a, A.Star):
                    _check_ordered_row_expr(a, cols)
            out.append(e)
            return
        if e.func == "count" and (not e.args or isinstance(e.args[0], A.Star)):
            out.append(e)
            return
        if e.func in fg._MATH:
            for a in e.args:
                _collect_ordered_aggs(a, cols, out)
            return
        raise Unsupported(f"call {e.func}")
    if isinstance(e, A.BinOp):
        _collect_ordered_aggs(e.left, cols, out)
        _collect_ordered_aggs(e.right, cols, out)
        return
    if isinstance(e, A.UnaryOp):
        _collect_ordered_aggs(e.operand, cols, out)
        return
    raise Unsupported(f"post-agg expr {e}")


# --------------------------------------------------------------------- #
# ordered row evaluation (sorted layout)
# --------------------------------------------------------------------- #

def _ordered_row_eval(e: A.Expr, env_sorted, pos, flags):
    """Evaluate a row expr over the group-sorted layout; windowed calls
    use the per-group positions and flags (ops/scan.py)."""
    if isinstance(e, A.Call) and e.func in _WINDOW_NAMES:
        if e.func == "subvec":
            raise Unsupported("subvec handled at projection level")
        args = list(e.args)
        w = None
        name = e.func
        if name in _W_SUFFIXED:
            name = _W_SUFFIXED[name]
            w = int(args[0].value)
            args = args[1:]
        elif len(args) == 2 and name in S.WINDOWED:
            w = int(args[0].value)
            args = args[1:]
        v = fg._as_rows(_ordered_row_eval(args[0], env_sorted, pos, flags),
                        pos)
        if w is None:
            return S.RUNNING[name](v, pos, flags)
        return S.WINDOWED[name](w, v, pos, flags)
    if isinstance(e, A.ColumnRef):
        return env_sorted[e.name.lower()]
    if isinstance(e, A.Literal):
        return e.value
    if isinstance(e, A.BinOp):
        return fg._binary(e.op,
                          _ordered_row_eval(e.left, env_sorted, pos, flags),
                          _ordered_row_eval(e.right, env_sorted, pos, flags))
    if isinstance(e, A.UnaryOp):
        return fg._unary(e.op, _ordered_row_eval(e.operand, env_sorted, pos,
                                                 flags))
    if isinstance(e, A.Call) and e.func in fg._MATH:
        return fg._math(e.func, [_ordered_row_eval(a, env_sorted, pos, flags)
                                 for a in e.args])
    raise Unsupported(f"ordered eval {e}")


# --------------------------------------------------------------------- #
# execution
# --------------------------------------------------------------------- #

def _int_bounds(col: Column):
    """(min, max) of an integer column from its stats, or None."""
    if col.data.is_floating_point() or col.data.dtype == torch.bool:
        return None
    return col.stats()


def run(sel: A.Select, table: Table) -> Table | None:
    """The ordered group-by of ``sel`` over ``table``: the result Table, or
    None when the plan does not cover the statement."""
    with span("plan"):
        try:
            p = plan(sel, table)
        except fg.Unsupported:
            return None
        n = table.nrows
        cols = table.columns
        col_order = fg.referenced_columns(p)
        if n == 0 or table.has_nulls(col_order):
            return None
    env = {nm: cols[nm].data for nm in col_order}
    cap = env[col_order[0]].shape[0]
    valid = torch.arange(cap, device=env[col_order[0]].device) < n
    if p["where"] is not None:
        valid = valid & fg._truth(fg._as_rows(fg._row_eval(p["where"], env),
                                              valid))
    with span("groupby.ordered"):
        got = ordered_groups(p, cols, n, env, valid)
    if got is None:
        return None
    with span("finish"):
        return to_table(p, cols, *got)


def ordered_groups(p, cols, n: int, env, valid, env_null=None, reduce=None):
    """The plan's groups over the rows of ``valid``: (each key's [g]
    values, each projection's result), or None where the float sums do
    not fit the exact lanes (fg.float_sums_fit; ``reduce`` combines its
    computed bounds over a mesh's ranks). A key or aggregate projection
    gives its [g] values, a row projection (values, [g] kept counts): the
    values of each group's kept rows, group after group, in ASSUMING
    order. env_null (name → [rows] NULL mask) makes the aggregates skip
    the NULL rows of those columns."""
    key_names = [k.name.lower() for k in p["keys"]]
    sort_cols = key_names + [an for an, _ in p["assume"]]
    sort_keys = []
    for nm, asc in [(kn, True) for kn in key_names] + p["assume"]:
        b = _int_bounds(cols[nm])
        sort_keys.append((env[nm], asc) if b is None else (env[nm], asc, b))
    perm, valid_s, sk, flags, last = fg.sorted_groups(
        valid, sort_keys[:len(key_names)], sort_keys[len(key_names):])
    env_sorted = {nm: env[nm][perm] for nm in env if nm not in sort_cols}
    for nm, x in zip(sort_cols, sk):
        env_sorted.setdefault(nm, x)
    null_fn = (fg.make_null_fn({nm: m[perm] for nm, m in env_null.items()})
               if env_null else None)
    pos = pos_from_flags(flags)

    def eval_sorted(e):
        return _ordered_row_eval(e, env_sorted, pos, flags)

    scatters = fg._needed_scatters(p["aggs"])
    if not fg.float_sums_fit(scatters, cols, n, eval_sorted, valid_s,
                             null_fn, reduce):
        return None
    add, mins, maxs, f64s = fg._build_lanes({}, valid_s, scatters,
                                            eval_fn=eval_sorted,
                                            null_fn=null_fn)
    outs, _ends = R.sorted_group_reduce(
        flags, last, add, mins, maxs, f64s,
        extract={f"__key{i}": x for i, x in enumerate(sk[:len(key_names)])},
        counts_from_ends="__counts__")
    counts = outs["__counts__"]
    keyvals = [outs[f"__key{i}"].to(cols[kn].data.dtype)
               for i, kn in enumerate(key_names)]
    results = []
    for kindp, expr, _alias in p["projections"]:
        if kindp == "key":
            results.append(keyvals[key_names.index(expr.name.lower())])
        elif kindp == "agg":
            results.append(fg._as_rows(fg._post_agg_eval(expr, outs, counts),
                                       counts))
        elif _is_window_call(expr) and expr.func == "subvec":
            base = fg._as_rows(eval_sorted(expr.args[0]), pos)
            a, b = int(expr.args[1].value), int(expr.args[2].value)
            with sync("groupby.ordered.subvec"):
                kept = base[valid_s & (pos >= a) & (pos < b)]
            results.append((kept, torch.clamp(counts, max=b)
                            - torch.clamp(counts, max=a)))
        else:
            vals = fg._as_rows(eval_sorted(expr), pos)
            with sync("groupby.ordered.rows"):
                g_rows = int(counts.sum())
            results.append((vals[:g_rows], counts))
    return keyvals, results


def to_table(p, cols, keyvals, results) -> Table:
    """The output Table of ordered_groups' results: key and aggregate
    projections as columns, row projections as VectorColumns."""
    g = int(keyvals[0].shape[0])
    out = Table(f"result_{base62uuid(4)}")
    for (kindp, expr, _alias), name, res in zip(
            p["projections"], fg.output_names(p["projections"]), results):
        if kindp == "key":
            src = cols[expr.name]
            out.add_column(Column(name, src.sqltype, res, nrows=g,
                                  dictionary=src.dictionary))
        elif kindp == "agg":
            out.add_column(Column(name, fg.sql_type(res), res, nrows=g))
        else:
            vals, kept = res
            offsets = torch.cat([kept.new_zeros(1), torch.cumsum(kept, 0)])
            out.add_column(VectorColumn(name, T.VectorT(fg.sql_type(vals)),
                                        vals, offsets, nrows=g,
                                        total=int(vals.shape[0])))
    return out
