"""The general single-table engine through both packages: the JAX package
(aquery2_tpu.connect()) and the port (aquery2_tpu_torch.connect("cpu"))
get identical tables from one numpy seed (``Table.from_reference`` carries
them across) and must return the same column names, SQL types, row order
and values: ungrouped aggregates of every dtype, the fused scan, DML,
CREATE TABLE AS, INSERT … SELECT, DISTINCT, UNION ALL, ASSUMING, the
reference's stock.a and moving_avg.a, the trades suite, subqueries,
three-valued logic over NULLs, and grouped queries the fused tiers
decline. Then the modules under them: ops/filter, ops/ragged,
ops/hashing, ops/agg and engine/groupby against the JAX package's.

Integers, counts and min/max compare exactly; float64 sums to
F64_SUM_RTOL (another order of summation); results through sqrt to
SQRT_RTOL (the last ulp of XLA's and torch's float64 sqrt differ). Where
the JAX package is wrong (ROADMAP queue 3) the port is held to numpy or
to SQL instead: a median or a corr over NULLs, first/last of a NULL, a
DELETE or UPDATE whose predicate is NULL, and ``next`` at the last row."""

import re

import numpy as np
import pytest
import torch
import torch_dist_world as W

import aquery2_tpu
import jax.numpy as jnp
from aquery2_tpu import types as JT
from aquery2_tpu.engine import groupby as JG
from aquery2_tpu.engine import executor as JE
from aquery2_tpu.ops import agg as JA
from aquery2_tpu.ops import filter as JFI
from aquery2_tpu.ops import hashing as JH
from aquery2_tpu.ops import ragged as JR
from aquery2_tpu.storage.table import (Column as JColumn,
                                       StringDict as JStringDict,
                                       Table as JTable)
from aquery2_tpu.utils.datagen import trades_table

import aquery2_tpu_torch
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import executor as TE
from aquery2_tpu_torch.engine import fused_scan as TS
from aquery2_tpu_torch.engine import groupby as TG
from aquery2_tpu_torch.ops import agg as TA
from aquery2_tpu_torch.ops import filter as TFI
from aquery2_tpu_torch.ops import hashing as TH
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops import ragged as TR
from aquery2_tpu_torch.storage.table import Table as TTable

F64_SUM_RTOL = 1e-12
SQRT_RTOL = 1e-15
N = 3000
STRINGS = ["sa", "sb", "sc", "sd", "se", "x1", "x21"]


def _jcol(nm, arr):
    if isinstance(arr, tuple):                  # (codes, strings)
        codes, strs = arr
        return JColumn(nm, JT.StrT, codes, dictionary=JStringDict(strs))
    valid = None
    if isinstance(arr, np.ma.MaskedArray):
        valid = ~np.ma.getmaskarray(arr)
        arr = arr.filled(0)
    return JColumn(nm, JT.from_np_dtype(arr.dtype), arr, valid=valid)


def _sessions(tables):
    """Both packages over {name: {col: array, masked array or (codes,
    strings)}}."""
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    add_tables(js, ts, tables)
    return js, ts


def add_tables(js, ts, tables):
    for name, cols in tables.items():
        ref = JTable(name, [_jcol(nm, a) for nm, a in cols.items()])
        js.catalog.create(ref, replace=True)
        ts.catalog.create(TTable.from_reference(ref, device="cpu"),
                          replace=True)


def _values(col):
    v = col.to_python()
    if col.is_vector:
        return [x for row in v for x in row], [len(row) for row in v]
    return v, None


def _compare(jr, tr, rtol=0.0):
    """Names, SQL types, row counts and every cell (floats to rtol, NULLs
    as None)."""
    jt = getattr(jr, "table", jr)
    tt = getattr(tr, "table", tr)
    assert list(tt.columns) == list(jt.columns)
    assert tt.nrows == jt.nrows
    for jc, tc in zip(jt.columns.values(), tt.columns.values()):
        assert tc.sqltype.name == jc.sqltype.name, tc.name
        assert tc.is_vector == jc.is_vector, tc.name
        (jv, jl), (tv, tl) = _values(jc), _values(tc)
        assert tl == jl, tc.name
        elem = tc.sqltype.elem if tc.is_vector else tc.sqltype
        if rtol and elem.np_dtype.kind == "f":
            assert [x is None for x in tv] == [x is None for x in jv], tc.name
            np.testing.assert_allclose(
                np.asarray([np.nan if x is None else x for x in tv], float),
                np.asarray([np.nan if x is None else x for x in jv], float),
                rtol=rtol, atol=0, err_msg=tc.name)
        else:
            np.testing.assert_array_equal(np.asarray(tv, dtype=object),
                                          np.asarray(jv, dtype=object),
                                          err_msg=tc.name)


def _both(sessions, sql, rtol=0.0):
    js, ts = sessions
    tr = ts.execute(sql)
    _compare(js.execute(sql), tr, rtol)
    return tr


@pytest.fixture(scope="module")
def base():
    rng = np.random.default_rng(9)
    t = {
        "g": rng.integers(1, 9, N).astype(np.int32),
        "h": rng.integers(0, 4, N).astype(np.int32),
        "s": (rng.integers(0, len(STRINGS), N).astype(np.int32), STRINGS),
        "a": rng.integers(-500, 500, N).astype(np.int32),
        "b": rng.integers(-2**40, 2**40, N),
        "c": np.round(rng.normal(size=N) * 10, 3).astype(np.float32),
        "d": rng.normal(size=N) * 1e3,
        "i8": rng.integers(-128, 128, N).astype(np.int8),
        "i16": rng.integers(-2**15, 2**15, N).astype(np.int16),
        "bo": rng.random(N) < 0.3,
        "ts": np.sort(rng.integers(0, N // 4, N)).astype(np.int32),
    }
    m = N // 2
    nt = {
        "g": rng.integers(1, 6, m).astype(np.int32),
        "k": np.ma.masked_array(rng.integers(0, 9, m).astype(np.int32),
                                mask=rng.random(m) < 0.1),
        "v": np.ma.masked_array(rng.integers(-20, 20, m).astype(np.int32),
                                mask=rng.random(m) < 0.2),
        "f": np.ma.masked_array(np.round(rng.random(m) * 10, 2),
                                mask=rng.random(m) < 0.2),
        "u": np.ma.masked_array(rng.integers(0, 50, m).astype(np.int32),
                                mask=rng.random(m) < 0.2),
    }
    return {"t": t, "nt": nt}


@pytest.fixture(scope="module")
def sessions(base):
    return _sessions(base)


# --- ungrouped aggregates ----------------------------------------------------

_AGG_COLS = ["a", "b", "c", "d", "i8", "i16", "bo"]


@pytest.mark.parametrize("col", _AGG_COLS)
def test_ungrouped_aggregates_match_jax(col, sessions):
    """Every aggregate of every dtype over the whole table, then under a
    WHERE (the general engine's one-group context)."""
    mm = "" if col == "bo" else f", min({col}) AS mn, max({col}) AS mx"
    sql = (f"SELECT sum({col}) AS s, avg({col}) AS av, count({col}) AS n"
           f"{mm}, first({col}) AS f, last({col}) AS l, var({col}) AS vr, "
           f"median({col}) AS md, corr({col}, a) AS r FROM t")
    _both(sessions, sql, F64_SUM_RTOL)
    _both(sessions, sql + " WHERE h = 2", F64_SUM_RTOL)
    _both(sessions, f"SELECT stddev({col}) AS sd FROM t", SQRT_RTOL)


def test_aggregates_of_an_empty_selection_match_jax(sessions):
    _both(sessions, "SELECT count(*) AS c, sum(a) AS s, avg(d) AS av, "
                    "min(a) AS mn, max(c) AS mx FROM t WHERE a > 10000")


def test_distinct_aggregate_raises(sessions, base):
    """The JAX package drops DISTINCT inside an aggregate (ROADMAP queue
    3), so the port's DISTINCT aggregates, which raised before item 7b,
    are held to numpy: the distinct values of a, over the table and per
    g."""
    _js, ts = sessions
    a, g = base["t"]["a"], base["t"]["g"]
    assert ts.execute("SELECT count(DISTINCT a) FROM t").rows() == [
        (len(np.unique(a)),)]
    r = ts.execute("SELECT g, sum(DISTINCT a) AS s FROM t GROUP BY g")
    keys = np.unique(g)
    np.testing.assert_array_equal(r.table["g"].to_numpy(), keys)
    np.testing.assert_array_equal(r.table["s"].to_numpy(),
                                  [np.unique(a[g == k]).sum() for k in keys])


# --- the fused scan ----------------------------------------------------------

SCANS = {
    "strings": "SELECT s, a FROM t WHERE s = 'sc' AND a < 100",
    "order_limit": "SELECT a, b + 1 AS b1 FROM t WHERE a > 0 "
                   "ORDER BY a, b1 LIMIT 50",
    "string_desc": "SELECT s, c, a FROM t ORDER BY s DESC, a LIMIT 20",
    "star_desc": "SELECT * FROM t WHERE g = 3 ORDER BY d DESC",
    "arith": "SELECT a * 2 + 1 AS x, d / 3 AS y, a % 7 AS m, a / 4 AS q, "
             "c * 1.5 AS cf FROM t WHERE NOT (a > 0 OR d < 0)",
    "case": "SELECT a, CASE WHEN a > 0 THEN a ELSE 0 END AS p FROM t "
            "LIMIT 10",
    "math": "SELECT sqrt(abs(d)) AS r FROM t ORDER BY r LIMIT 5",
    "alias_order": "SELECT a - h AS z, s FROM t WHERE s <> 'sa' "
                   "ORDER BY z DESC, s LIMIT 30",
    "absent_string": "SELECT a FROM t WHERE s = 'nope'",
    "all_rows": "SELECT ts, a FROM t",
    "mod_zero": "SELECT a % h AS m, i8 % 0 AS z, d % h AS fm FROM t "
                "WHERE g < 3",
}


@pytest.mark.parametrize("name", sorted(SCANS))
def test_fused_scan_matches_jax(name, sessions, monkeypatch):
    """Each shape takes the fused scan in both packages and agrees."""
    taken = []
    real = TS.try_run

    def spy(catalog, sel):
        out = real(catalog, sel)
        taken.append(out is not None)
        return out

    monkeypatch.setattr(TS, "try_run", spy)
    # XLA divides by a constant as a multiply by its reciprocal: the last
    # ulp of d / 3 differs
    # (and mod_zero's float NaNs compare through assert_allclose)
    _both(sessions, SCANS[name], SQRT_RTOL if name in ("math", "arith",
                                                       "mod_zero") else 0.0)
    assert taken == [True]


def test_fused_scan_declines_to_the_general_engine(sessions, monkeypatch):
    """NULLs, LIKE, string ranges, aggregates: None, and the general
    engine answers as the JAX package does."""
    calls = []
    real = TS.try_run
    monkeypatch.setattr(TS, "try_run", lambda c, s: calls.append(1)
                        or real(c, s))
    for sql in ("SELECT v, f FROM nt WHERE v > 2",
                "SELECT s, a FROM t WHERE s LIKE 's%'",
                "SELECT a FROM t WHERE s > 'sb' ORDER BY a LIMIT 5",
                "SELECT count(*) FROM t"):
        js, ts = sessions
        sel = aquery2_tpu_torch.parser.parse(sql)[0]
        assert real(ts.catalog, sel) is None, sql
        _both(sessions, sql)


# --- the general engine ------------------------------------------------------

GENERAL = {
    "best_profit": "SELECT max(a - mins(a)) AS bp FROM t",
    "best_profit_desc": "SELECT max(a - mins(a)) AS bp FROM t "
                        "ASSUMING DESC ts",
    "deviation": "SELECT a - avg(a) AS dev FROM t",
    "running": "SELECT sums(a) AS s, avgs(a) AS av, mins(c) AS mn, "
               "maxs(d) AS mx, deltas(a) AS dl, prev(a) AS p FROM t "
               "ASSUMING ASC ts",
    "windowed": "SELECT avgs(3, a) AS a3, sums(5, b) AS s5, mins(4, a) AS m4,"
                " maxs(2, c) AS x2, sumw(3, i8) AS w3 FROM t "
                "ASSUMING DESC ts",
    "running_f64": "SELECT vars(a) AS v, stddevs(3, a) AS sd, ratios(d) AS r "
                   "FROM t ASSUMING ASC ts",
    "like": "SELECT s, a FROM t WHERE s LIKE 'x%'",
    "string_range": "SELECT count(*) AS c FROM t WHERE s >= 'sc' AND s < 'x1'",
    "in_subquery": "SELECT a FROM t WHERE h IN (SELECT g FROM t WHERE g < 3) "
                   "ORDER BY a LIMIT 40",
    "scalar_subquery": "SELECT a FROM t WHERE a > (SELECT avg(a) FROM t) "
                       "ORDER BY a DESC LIMIT 10",
    "derived_table": "SELECT sum(x) AS sx, count(*) AS c FROM "
                     "(SELECT a AS x FROM t WHERE g = 2)",
    "no_from": "SELECT 1 + 2 AS x, 2.5 * 2 AS y",
    "mod_zero": "SELECT sum(a % h) AS s, max(b % (h - 1)) AS m FROM t",
    "order_expr": "SELECT a, d FROM t ORDER BY a * d LIMIT 7",
    "pow": "SELECT pow(a, 2) AS p, pow(d, 0.5) AS q FROM t WHERE g = 1",
    "case_string": "SELECT CASE WHEN s = 'sa' THEN 1 ELSE 2 END AS k, "
                   "count(*) AS c FROM t GROUP BY CASE WHEN s = 'sa' THEN 1 "
                   "ELSE 2 END",
}


@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_engine_matches_jax(name, sessions):
    rtol = SQRT_RTOL if name == "running_f64" else F64_SUM_RTOL
    _both(sessions, GENERAL[name], rtol)


GROUPED = {
    "first_last": "SELECT g, first(a) AS f, last(a) AS l, "
                  "last(mins(a)) AS lm FROM t ASSUMING ASC ts GROUP BY g",
    "ordered_having": "SELECT g, sums(a) AS s FROM t ASSUMING ASC ts "
                      "GROUP BY g HAVING max(a) > 490 ORDER BY g DESC "
                      "LIMIT 3",
    "ordered_order": "SELECT g, avgs(3, a) AS m FROM t ASSUMING ASC ts "
                     "GROUP BY g ORDER BY g DESC",
    "ordered_limit": "SELECT g, max(stddevs(3, a)) AS m FROM t "
                     "ASSUMING ASC ts GROUP BY g LIMIT 4",
    "computed_key": "SELECT g + h AS k, first(d) AS f, count(*) AS c "
                    "FROM t GROUP BY g + h",
    "subvec": "SELECT g, subvec(a, 1, 3) AS sv FROM t ASSUMING DESC a "
              "GROUP BY g ORDER BY g DESC",
    "bare_column": "SELECT h, a FROM t GROUP BY h",
    "string_key": "SELECT s, first(a) AS f, max(d) AS mx FROM t GROUP BY s "
                  "ORDER BY s DESC",
    "float_key": "SELECT c, last(a) AS l FROM t WHERE g = 2 GROUP BY c",
    "wide_key": "SELECT b, g, first(a) AS f FROM t WHERE h = 1 "
                "GROUP BY b, g ORDER BY f LIMIT 9",
    "order_by_row": "SELECT g, count(*) AS c FROM t GROUP BY g "
                    "ORDER BY first(a)",
}


@pytest.mark.parametrize("name", sorted(GROUPED))
def test_grouped_general_matches_jax(name, sessions):
    _both(sessions, GROUPED[name], SQRT_RTOL)


def test_empty_table_matches_jax():
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    for db in (js, ts):
        db.execute("CREATE TABLE e(g INT, v INT, f DOUBLE)")
    for sql in ("SELECT g, sum(v) AS s FROM e GROUP BY g",
                "SELECT g, sums(v) AS s FROM e ASSUMING ASC v GROUP BY g",
                "SELECT count(*) AS c, sum(v) AS s FROM e",
                "SELECT g, v FROM e WHERE v > 1"):
        _compare(js.execute(sql), ts.execute(sql))


def test_vector_columns_match_python(sessions):
    """A table with a vector column (made by CREATE TABLE AS of an ordered
    query, equal in both packages): WHERE (each row's vector gathered by
    ops/ragged.take), ORDER BY, LIMIT and UNION ALL, held to the same
    operations on its Python rows (the JAX package fails a WHERE over a
    vector column: ROADMAP queue 3)."""
    js, ts = sessions
    for db in (js, ts):
        db.execute("CREATE TABLE vt AS SELECT g, sums(a) AS s FROM t "
                   "ASSUMING ASC ts GROUP BY g")
    _compare(js.catalog.get("vt"), ts.catalog.get("vt"))
    rows = ts.execute("SELECT * FROM vt").rows()
    assert ts.execute("SELECT * FROM vt WHERE g > 3").rows() == \
        [r for r in rows if r[0] > 3]
    assert ts.execute("SELECT * FROM vt ORDER BY g DESC LIMIT 3").rows() \
        == sorted(rows, reverse=True)[:3]
    assert ts.execute("SELECT * FROM vt UNION ALL SELECT * FROM vt "
                      "WHERE g < 3").rows() == \
        rows + [r for r in rows if r[0] < 3]


def test_next_keeps_the_last_rows_value(sessions):
    """next (aggnext) shifts left; the last row keeps its own value (the
    JAX package reads the row past the end there: ROADMAP queue 3)."""
    _js, ts = sessions
    r = ts.execute("SELECT a, next(a) AS nx FROM t ASSUMING ASC ts")
    a = r.table["a"].to_numpy()
    np.testing.assert_array_equal(r.table["nx"].to_numpy(),
                                  np.r_[a[1:], a[-1:]])


# --- NULLs ------------------------------------------------------------------

NULLS = {
    "where": "SELECT g, sum(u) AS s, count(*) AS c FROM nt WHERE v > 2 "
             "GROUP BY g",
    "kleene_where": "SELECT count(*) AS c FROM nt WHERE v > 2 OR f < 5",
    "kleene_and": "SELECT g, count(*) AS c FROM nt WHERE v > 2 AND f < 5 "
                  "GROUP BY g",
    "not_null": "SELECT count(*) AS c FROM nt WHERE NOT (v > 0)",
    "kleene_arg": "SELECT g, sum(v > 2 AND f < 5) AS s, "
                  "count(v > 2 OR f < 5) AS c FROM nt GROUP BY g",
    "key_outside": "SELECT k, sum(k) AS s, count(k) AS c FROM nt GROUP BY k",
    "key_where": "SELECT k, count(*) AS c FROM nt WHERE k > 2 GROUP BY k",
    "ungrouped": "SELECT sum(v) AS s, avg(f) AS av, count(v) AS c, "
                 "min(v) AS mn, max(f) AS mx, var(u) AS vr FROM nt",
    "rows": "SELECT g, v + u AS w, f * 2 AS f2 FROM nt WHERE g < 3",
    "case": "SELECT v, f, CASE WHEN v > 3 THEN f ELSE 0.5 END AS x FROM nt",
    "case_no_else": "SELECT CASE WHEN v > 3 THEN u END AS x FROM nt",
    "order_nulls": "SELECT v, g FROM nt ORDER BY v, g LIMIT 40",
    "order_nulls_desc": "SELECT g, v FROM nt WHERE g = 1 ORDER BY v DESC",
    "distinct": "SELECT DISTINCT k FROM nt",
    "null_key_order": "SELECT k, avg(v + 2) AS x FROM nt GROUP BY k "
                      "ORDER BY k DESC",
    "null_key_order_asc": "SELECT k, count(*) AS c FROM nt GROUP BY k "
                          "ORDER BY k LIMIT 4",
    "having": "SELECT g, avg(v) AS av FROM nt GROUP BY g HAVING sum(v) > 0",
}


@pytest.mark.parametrize("name", sorted(NULLS))
def test_nulls_match_jax(name, sessions):
    _both(sessions, NULLS[name], F64_SUM_RTOL)


def _nt(ts):
    t = ts.catalog.get("nt")
    return {nm: np.ma.masked_array(
        t[nm].to_numpy(), mask=np.zeros(t.nrows, bool) if t[nm].valid is None
        else ~t[nm].valid[:t.nrows].numpy()) for nm in t.columns}


def test_null_median_corr_first_last_match_numpy(sessions):
    """Where the JAX package is wrong over NULLs (ROADMAP queue 3): median
    and corr skip the NULL rows, first and last keep a NULL."""
    _js, ts = sessions
    d = _nt(ts)
    r = ts.execute("SELECT g, median(v) AS m, corr(v, f) AS r, "
                   "first(v) AS fv, last(u) AS lu FROM nt GROUP BY g")
    cols = r.table.columns
    for i, g in enumerate(np.unique(d["g"])):
        rows = d["g"].data == g
        v = d["v"][rows]
        assert cols["m"].to_numpy()[i] == np.ma.median(v.compressed())
        both = ~np.ma.getmaskarray(v) & ~np.ma.getmaskarray(d["f"][rows])
        x = v.data[both].astype(np.float64)
        y = d["f"].data[rows][both]
        nn, sx, sy = len(x), x.sum(), y.sum()
        want = (nn * (x * y).sum() - sx * sy) / np.sqrt(
            (nn * (x * x).sum() - sx * sx) * (nn * (y * y).sum() - sy * sy))
        np.testing.assert_allclose(cols["r"].to_numpy()[i], want, rtol=1e-12)
        first = v[0]
        assert cols["fv"].to_python()[i] == (None if first is np.ma.masked
                                             else int(first))
        lu = d["u"][rows][-1]
        assert cols["lu"].to_python()[i] == (None if lu is np.ma.masked
                                             else int(lu))
    m = ts.execute("SELECT median(v) AS m FROM nt").scalar()
    assert m == np.ma.median(d["v"].compressed())


# --- DISTINCT and UNION ALL --------------------------------------------------

SETS = {
    "distinct": "SELECT DISTINCT g FROM t",
    "distinct_two": "SELECT DISTINCT g, s FROM t",
    "distinct_expr": "SELECT DISTINCT g * 2 AS x FROM t ORDER BY x DESC",
    "distinct_where": "SELECT DISTINCT h FROM t WHERE a > 400",
    "union": "SELECT a, s FROM t WHERE g = 1 UNION ALL "
             "SELECT a, s FROM t WHERE g = 2",
    "union_order": "SELECT a, s FROM t WHERE g = 1 UNION ALL "
                   "SELECT a, s FROM t WHERE g = 2 ORDER BY a LIMIT 20",
    "union_groups": "SELECT g, sum(a) AS x FROM t GROUP BY g UNION ALL "
                    "SELECT h, sum(a) AS x FROM t GROUP BY h",
    "union_star": "SELECT * FROM t UNION ALL SELECT * FROM t",
    "union_nulls": "SELECT v, f FROM nt WHERE g = 1 UNION ALL "
                   "SELECT u, f FROM nt WHERE g = 2 ORDER BY f DESC",
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_distinct_and_union_all_match_jax(name, sessions):
    _both(sessions, SETS[name])


def test_set_operations_raise(sessions):
    """UNION, EXCEPT and a DISTINCT that does not rewrite as GROUP BY,
    which raised before item 7b, equal the JAX package."""
    for sql in ("SELECT a FROM t UNION SELECT a FROM t",
                "SELECT a FROM t EXCEPT SELECT h FROM t",
                "SELECT DISTINCT * FROM t"):
        _both(sessions, sql)


# --- statements -------------------------------------------------------------

# --- IN over a subquery and positional items, held to SQL --------------------

@pytest.fixture(scope="module")
def fault_session():
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.execute(W.SQL_FAULT_TABLES)
    return ts


@pytest.mark.parametrize("tag", sorted(W.SQL_FAULTS))
def test_in_subquery_and_positions_follow_sql(tag, fault_session):
    """IN and NOT IN over a subquery in three-valued logic (a NULL probe,
    or a missed probe against a subquery holding a NULL, is NULL), on
    integer and string operands; ORDER BY n and GROUP BY n as the n-th
    select item. The JAX package shares the first fault and gets the
    second wrong or raises (ROADMAP queue 3), so each statement is held
    to its SQL answer."""
    sql, want = W.SQL_FAULTS[tag]
    got = fault_session.execute(sql).rows()
    assert W.sql_answer_matches(sql, got, want), (got, want)


@pytest.mark.parametrize("sql", sorted(W.SQL_FAULT_RAISES))
def test_positions_out_of_reach_raise(sql, fault_session):
    """A position out of range, behind a *, or naming an aggregate in
    GROUP BY raises instead of answering."""
    with pytest.raises(TE.ExecError, match=re.escape(W.SQL_FAULT_RAISES[sql])):
        fault_session.execute(sql)


# positional form, and the named form the JAX package answers
POSITIONAL = {
    "dense": ("SELECT g, sum(a) AS s FROM t GROUP BY 1 ORDER BY 2 DESC",
              "SELECT g, sum(a) AS s FROM t GROUP BY g ORDER BY s DESC"),
    "packed": ("SELECT b, count(*) AS c FROM t WHERE h = 1 GROUP BY 1 "
               "ORDER BY 2 DESC, 1 LIMIT 9",
               "SELECT b, count(*) AS c FROM t WHERE h = 1 GROUP BY b "
               "ORDER BY c DESC, b LIMIT 9"),
    "fused_scan": ("SELECT a, d FROM t ORDER BY 2, 1 LIMIT 7",
                   "SELECT a, d FROM t ORDER BY d, a LIMIT 7"),
    "general": ("SELECT a - avg(a) AS dev FROM t ORDER BY 1 DESC LIMIT 9",
                "SELECT a - avg(a) AS dev FROM t ORDER BY dev DESC LIMIT 9"),
    "ordered": ("SELECT g, sums(a) AS s FROM t ASSUMING ASC ts GROUP BY 1 "
                "ORDER BY 1 DESC",
                "SELECT g, sums(a) AS s FROM t ASSUMING ASC ts GROUP BY g "
                "ORDER BY g DESC"),
    "distinct": ("SELECT DISTINCT h, g FROM t ORDER BY 2 DESC, 1",
                 "SELECT DISTINCT h, g FROM t ORDER BY g DESC, h"),
    "string_key": ("SELECT s, max(d) AS mx FROM t GROUP BY 1 ORDER BY 1 DESC",
                   "SELECT s, max(d) AS mx FROM t GROUP BY s ORDER BY s "
                   "DESC"),
}


@pytest.mark.parametrize("name", sorted(POSITIONAL))
def test_positions_resolve_before_every_tier(name, sessions):
    """A positional item is resolved before any tier sees the statement,
    so each tier answers it as the named item: equal to the JAX package's
    answer to the named form."""
    js, ts = sessions
    pos, named = POSITIONAL[name]
    _compare(js.execute(named), ts.execute(pos), SQRT_RTOL)


DML = [
    "CREATE TABLE d(a INT, s VARCHAR(10), f DOUBLE)",
    "INSERT INTO d VALUES (1, 'x', 1.5), (2, 'y', 2.5), (3, 'x', 3.5), "
    "(4, 'z', 4.5), (5, 'y', 0.5)",
    "UPDATE d SET f = f * 2 WHERE a > 2",
    "UPDATE d SET s = 'w', a = a + 100 WHERE a = 1",
    "DELETE FROM d WHERE s = 'y'",
    "INSERT INTO d SELECT a + 10, s, f FROM d WHERE a < 4",
    "INSERT INTO d VALUES (1 + 1, 'q', 2.0 * 3)",
    "CREATE TABLE e AS SELECT a, f FROM d WHERE f > 3",
    "INSERT INTO e SELECT a * 2, f FROM e",
    "UPDATE e SET f = 0.0",
    "SELECT a, s INTO e2 FROM d WHERE a > 3",
    "SELECT s, count(*) AS c, sum(f) AS sf INTO e3 FROM d GROUP BY s",
    "CREATE INDEX ix ON d(a)",
    "DELETE FROM e2",
    "INSERT INTO e2 VALUES (7, 'x')",
    "CREATE TABLE vv(a INT, x vecInt)",
    "INSERT INTO vv VALUES (1, 5), (2, 7)",
    "INSERT INTO vv SELECT * FROM vv",
]


def test_dml_sequence_matches_jax():
    """Each statement in turn through both packages; after each, every
    table compares equal."""
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    for stmt in DML:
        js.execute(stmt)
        ts.execute(stmt)
        assert sorted(ts.catalog.names()) == sorted(js.catalog.names())
        for name in ts.catalog.names():
            _compare(js.catalog.get(name), ts.catalog.get(name))
    js.execute("DROP TABLE e")
    ts.execute("DROP TABLE e; DROP TABLE IF EXISTS nothing")
    assert sorted(ts.catalog.names()) == sorted(js.catalog.names())


def test_dml_over_nulls_follows_sql():
    """DELETE removes the rows whose predicate is TRUE (a NULL predicate
    keeps the row) and UPDATE sets those rows, NULLs included, keeping
    every other row's NULL (the JAX package deletes NULL-predicate rows
    and drops the validity: ROADMAP queue 3)."""
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.execute("CREATE TABLE n(a INT, v INT, s VARCHAR(5));"
               "INSERT INTO n VALUES (1, NULL, 'p'), (2, 5, 'q'), "
               "(3, NULL, 'p'), (4, 9, 'r'), (5, 1, NULL)")
    ts.execute("DELETE FROM n WHERE v > 4")
    assert ts.execute("SELECT * FROM n").rows() == [
        (1, None, "p"), (3, None, "p"), (5, 1, None)]
    ts.execute("UPDATE n SET v = a * 10 WHERE a > 2;"
               "UPDATE n SET s = 'z' WHERE v IS NULL")
    assert ts.execute("SELECT * FROM n").rows() == [
        (1, None, "z"), (3, 30, "p"), (5, 50, None)]
    ts.execute("UPDATE n SET v = NULL WHERE a = 5")
    assert ts.execute("SELECT v FROM n").rows() == [(None,), (30,), (None,)]


def test_float_literals_keep_float64():
    """A float literal is a float64 value: SELECT 1.9 gives 1.9, as the
    JAX package gives it, not its float32 rounding 1.899999976158142."""
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    for db in (js, ts):
        db.execute("CREATE TABLE f1(a INT)")
        db.execute("INSERT INTO f1 VALUES (1), (2)")
    for sql in ("SELECT 1.9 AS a, 0.1 AS b", "SELECT a, 1.9 AS b FROM f1"):
        assert ts.execute(sql).rows() == js.execute(sql).rows()
    assert ts.execute("SELECT 1.9 AS a").rows() == [(1.9,)]


def test_statements_that_stay_out_raise(tmp_path):
    """LOAD, INTO OUTFILE, an AGGREGATION FUNCTION the rewrite declines,
    LOAD MODULE and CREATE/DROP TRIGGER all answer now, as the JAX package
    does (none raises any more)."""
    ts = aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path))
    js = aquery2_tpu.connect(base_dir=str(tmp_path))
    (tmp_path / "x.csv").write_text("a\n3\n1\n4\n1\n5\n")
    (tmp_path / "m.py").write_text("def f(a):\n    return a * 2 + 1\n")
    for db in (ts, js):
        db.execute("CREATE TABLE t(a INT)")
        # a loop over half the group does not rewrite into aggregates
        db.execute("AGGREGATION FUNCTION half(x){ s := 0; for (i := 0; "
                   "i < _builtin_len / 2; i += 1) { s += x[i]; } s }")
        db.execute('LOAD DATA INFILE "x.csv" INTO TABLE t')
    assert ts.execute("SELECT a FROM t").rows() == \
        js.execute("SELECT a FROM t").rows() == [(3,), (1,), (4,), (1,), (5,)]
    for db, name in ((ts, "o_t.csv"), (js, "o_j.csv")):
        db.execute(f'SELECT a FROM t INTO OUTFILE "{name}"')
    assert (tmp_path / "o_t.csv").read_text() == \
        (tmp_path / "o_j.csv").read_text() == "3\n1\n4\n1\n5\n"
    assert ts.execute("SELECT half(a) AS h FROM t").rows() == \
        js.execute("SELECT half(a) AS h FROM t").rows() == [(8.0,)]
    got = []
    for db in (ts, js):
        db.execute('LOAD MODULE FROM "m.py" FUNCTIONS (f(a:int) -> int)')
        db.execute("CREATE TRIGGER tr ON t ACTION p WHEN q")
        names = sorted(db.triggers.triggers)
        db.execute("DROP TRIGGER tr")
        got.append((db.execute("SELECT f(a) FROM t").rows(), names,
                    sorted(db.triggers.triggers)))
        db.close()
    assert got[0] == got[1] == ([(7,), (3,), (9,), (3,), (11,)], ["tr"], [])


# --- the reference's scripts --------------------------------------------------

PRICES = [15, 19, 16, 17, 15, 13, 5, 8, 7, 13, 11, 14, 10, 5, 2, 5]
STOCK = {
    "q1": "SELECT max(price-min(timestamp)) FROM stocks",
    "q2": "SELECT max(price-mins(price)) FROM stocks",
    "q3": "SELECT price, timestamp FROM stocks where price - timestamp > 1 "
          "and not (price*timestamp<100)",
    "q4": "SELECT max(price-mins(price)) FROM stocks ASSUMING DESC timestamp",
    "moving_avg": "SELECT Mont, avgs(3,sales) FROM sale ASSUMING ASC Mont",
    "moving_avg_grouped": "select Mont, mins(2,sales) from sale "
                          "assuming desc Mont group by Mont",
}


@pytest.fixture(scope="module")
def scripts():
    rng = np.random.default_rng(12)
    return _sessions({
        "stocks": {"timestamp": np.arange(1, 17, dtype=np.int32),
                   "price": np.asarray(PRICES, np.int32)},
        "sale": {"Mont": rng.permutation(np.repeat(np.arange(1, 13), 3))
                 .astype(np.int32),
                 "sales": rng.integers(100, 900, 36).astype(np.int32)}})


@pytest.mark.parametrize("name", sorted(STOCK))
def test_reference_scripts_match_jax(name, scripts):
    r = _both(scripts, STOCK[name])
    if name in ("q2", "q4"):
        p = np.asarray(PRICES[::-1] if name == "q4" else PRICES)
        assert r.scalar() == (p - np.minimum.accumulate(p)).max()


@pytest.fixture(scope="module")
def trade_sessions():
    js = aquery2_tpu.connect()
    trades_table("trade1m", 20_000, n_symbols=50, seed=7, session=js)
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.catalog.create(TTable.from_reference(js.catalog.get("trade1m"),
                                            device="cpu"))
    return js, ts


TRADES = {
    "q0": "<sql>CREATE TABLE res0 AS SELECT * FROM trade1m</sql>",
    "q1": "<sql>CREATE TABLE res1 AS SELECT avg(quantity) AS avg_quan, "
          "min(price) AS min_p FROM trade1m GROUP BY stocksymbol, time</sql>",
    "q2": "<sql>SELECT COUNT(*) FROM trade1m</sql>",
    "q3": "SELECT sum(quantity) as sum_quantity FROM trade1m "
          "GROUP BY stocksymbol, price",
    "q4": "SELECT * FROM trade1m UNION ALL SELECT * FROM trade1m",
    "q7": "SELECT stocksymbol, avgs(5, price) FROM trade1m "
          "ASSUMING ASC time GROUP BY stocksymbol",
    "q8": "SELECT stocksymbol, quantity, price FROM trade1m "
          "WHERE time >= 100 and time <= 700",
    "q9": "SELECT stocksymbol, MAX(price) - MIN(price) FROM trade1m "
          "GROUP BY stocksymbol",
    "q10": "SELECT stocksymbol, MAX(stddevs(3, price)) FROM trade1m "
           "ASSUMING ASC time GROUP BY stocksymbol",
    "topk": "SELECT stocksymbol, time, price FROM trade1m WHERE quantity > 50"
            " ORDER BY price DESC, time LIMIT 100",
    "dml": "<sql>CREATE TABLE r AS SELECT * FROM trade1m;"
           "DELETE FROM r WHERE price > 450;"
           "UPDATE r SET quantity = quantity + 1 WHERE time < 200;"
           "INSERT INTO r SELECT * FROM trade1m WHERE price > 475;"
           "SELECT count(*), sum(quantity), sum(price) FROM r</sql>",
}


@pytest.mark.parametrize("name", sorted(TRADES))
def test_trades_suite_matches_jax(name, trade_sessions):
    js, ts = trade_sessions
    sql = TRADES[name]
    jr, tr = js.execute(sql), ts.execute(sql)
    if jr is None:                       # CREATE TABLE AS: the new table
        tname = sql.split("TABLE ")[1].split()[0]
        jr, tr = js.catalog.get(tname), ts.catalog.get(tname)
    _compare(jr, tr, SQRT_RTOL if name == "q10" else F64_SUM_RTOL)


# --- the modules ------------------------------------------------------------

def test_filter_compacts_in_order(rng):
    mask = rng.random(5000) < 0.3
    jperm, jcnt = JFI.compact_indices(jnp.asarray(mask))
    idx, cnt = TFI.compact_indices(torch.from_numpy(mask))
    assert cnt == int(jcnt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jperm)[:cnt])


def test_ragged_take_and_expand_match_jax(rng):
    lens = rng.integers(0, 5, 40)
    lens[5] = 0
    offsets = np.r_[0, np.cumsum(lens)].astype(np.int64)
    values = rng.integers(-9, 9, int(offsets[-1])).astype(np.int32)
    perm = rng.permutation(40)[:25].astype(np.int32)
    total = int(lens[perm[:20]].sum())
    jv, jo = JR.take(jnp.asarray(values), jnp.asarray(offsets),
                     jnp.asarray(perm), 20, 128, total)
    tv, to = TR.take(torch.from_numpy(values), torch.from_numpy(offsets),
                     torch.from_numpy(perm).long(), 20, 128, total)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tv.numpy()[:total], np.asarray(jv)[:total])
    for a, b in zip(JR.expand(jnp.asarray(lens), 200, int(lens.sum())),
                    TR.expand(torch.from_numpy(lens), 200, int(lens.sum()))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_hashing_matches_jax(rng):
    keys = [rng.integers(-5, 20, 3000).astype(np.int32),
            rng.integers(100, 103, 3000).astype(np.int32)]
    meta = [(int(k.min()), int(k.max())) for k in keys]
    jc, jd, js_ = JH.dense_pack([(jnp.asarray(k), mn, mx)
                                 for k, (mn, mx) in zip(keys, meta)])
    tc, td, ts_ = TH.dense_pack([(torch.from_numpy(k), mn, mx)
                                 for k, (mn, mx) in zip(keys, meta)])
    assert (td, ts_) == (jd, js_)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for a, b in zip(JH.dense_unpack(jc, meta, js_),
                    TH.dense_unpack(tc, meta, ts_)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    lanes = [rng.integers(-2**62, 2**62, 3000), rng.normal(size=3000),
             rng.normal(size=3000).astype(np.float32),
             rng.random(3000) < 0.5]
    jh = [JH.hash64(JH.bits64(jnp.asarray(x))) for x in lanes]
    th = [TH.hash64(TH.bits64(torch.from_numpy(x))) for x in lanes]
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b.numpy().view(np.uint64),
                                      np.asarray(a))
    np.testing.assert_array_equal(
        TH.combine_hashes(th).numpy().view(np.uint64),
        np.asarray(JH.combine_hashes(jh)))


@pytest.mark.parametrize("dtype", ["int8", "int32", "int64", "float32",
                                   "float64"])
def test_agg_matches_jax(dtype, rng):
    n = 2000
    x = (rng.normal(size=2048) * 100).astype(dtype)
    y = rng.integers(-50, 50, 2048).astype(np.int32)
    for name, (fn, arity) in TA.SCALAR_AGGS.items():
        jfn = JA.SCALAR_AGGS[name][0]
        args = (x, y)[:arity]
        got = fn(*(torch.from_numpy(a) for a in args), n)
        want = jfn(*(jnp.asarray(a) for a in args), n)
        assert got.dtype == T.torch_dtype(np.asarray(want).dtype), name
        rtol = SQRT_RTOL if name in ("stddev", "corr", "var") \
            else F64_SUM_RTOL
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["dense", "dense_two", "sort_float",
                                  "sort_wide", "empty_tail"])
def test_group_by_matches_jax(case, rng):
    n, cap = 2500, 3072
    if case == "dense":
        keys = [rng.integers(3, 40, cap).astype(np.int32)]
    elif case == "dense_two":
        keys = [rng.integers(0, 5, cap).astype(np.int32),
                rng.integers(-3, 3, cap).astype(np.int64)]
    elif case == "sort_float":
        keys = [np.round(rng.normal(size=cap), 1)]
    elif case == "sort_wide":
        keys = [rng.integers(-2**40, 2**40, cap) // 2**30,
                rng.integers(0, 3, cap).astype(np.int32)]
    else:
        keys = [rng.integers(0, 4, cap).astype(np.int32)]
        n = 3
    jg = JG.group_by([JE._KeyCol(jnp.asarray(k), n) for k in keys], n)
    tg = TG.group_by([TE._KeyCol(torch.from_numpy(k), n) for k in keys], n)
    g = tg.num_groups
    assert g == jg.num_groups
    for a, b in zip(jg.key_values, tg.key_values):
        np.testing.assert_array_equal(b.numpy()[:g], np.asarray(a)[:g])
    np.testing.assert_array_equal(tg.seg_ids.numpy()[:n],
                                  np.asarray(jg.seg_ids)[:n])
    np.testing.assert_array_equal(tg.order.numpy()[:n],
                                  np.asarray(jg.order)[:n])
    np.testing.assert_array_equal(tg.offsets.numpy()[:g + 1],
                                  jg.offsets)
    np.testing.assert_array_equal(tg.pos.numpy()[:n],
                                  np.asarray(jg.pos)[:n])


def test_general_path_on_cpu_launches_nothing(sessions):
    """CPU tensors take the kernels' plain versions: no launches."""
    before = dict(K.LAUNCHES)
    _both(sessions, GENERAL["best_profit"])
    assert K.LAUNCHES == before


@pytest.fixture
def rng():
    return np.random.default_rng(2024)
