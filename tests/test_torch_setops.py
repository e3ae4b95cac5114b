"""Set operations and DISTINCT aggregates through both packages.

The JAX package (aquery2_tpu.connect()) and the port (aquery2_tpu_torch
.connect("cpu")) get identical tables and must return the same column
names, SQL types, row order and values: every case of
tests/test_outer_set_ops.py (outer joins, EXCEPT [ALL], INTERSECT [ALL],
UNION), then NULLs, strings in two dictionaries, float -0.0, chains,
UNION over DISTINCT and DISTINCT over a UNION. Where the JAX package is
wrong (ROADMAP queue 3) the port is held to numpy or to SQL instead: its
set operations never match NaN with NaN (Python's tuple compare), and it
drops DISTINCT inside an aggregate."""

import numpy as np
import pytest

import aquery2_tpu
from aquery2_tpu import types as JT
from aquery2_tpu.storage.table import (Column as JColumn,
                                       StringDict as JStringDict,
                                       Table as JTable)

import aquery2_tpu_torch
from aquery2_tpu_torch.engine import executor as TE
from aquery2_tpu_torch.engine.eval import EvalError
from aquery2_tpu_torch.storage.table import Table as TTable

_OUTER_SETUP = ["CREATE TABLE l(k INT, x INT)", "CREATE TABLE r(k INT, y INT)",
                "INSERT INTO l VALUES (1, 10), (2, 20), (3, 30)",
                "INSERT INTO r VALUES (2, 200), (3, 300), (4, 400)"]
_BAGS = ["CREATE TABLE a(v INT)", "CREATE TABLE b(v INT)"]

# tests/test_outer_set_ops.py, case by case: (extra statements, query)
OUTER_SET_OPS = {
    "left_join": ([], "SELECT l.k, x, y FROM l LEFT JOIN r ON l.k = r.k "
                      "ORDER BY l.k"),
    "left_outer_join_keyword": ([], "SELECT l.k, y FROM l LEFT OUTER JOIN r "
                                    "ON l.k = r.k ORDER BY l.k"),
    "right_join": ([], "SELECT r.k, x, y FROM l RIGHT JOIN r ON l.k = r.k "
                       "ORDER BY r.k"),
    "full_join": ([], "SELECT x, y FROM l FULL OUTER JOIN r ON l.k = r.k"),
    "left_join_using": ([], "SELECT k, x, y FROM l LEFT JOIN r USING (k) "
                            "ORDER BY k"),
    "outer_join_null_side_aggregates": (
        [], "SELECT count(y), count(*) FROM l LEFT JOIN r ON l.k = r.k"),
    "outer_join_is_null_filter": (
        [], "SELECT l.k FROM l LEFT JOIN r ON l.k = r.k WHERE y IS NULL"),
    "outer_join_then_groupby": (
        ["INSERT INTO l VALUES (2, 21)"],
        "SELECT l.k, count(y) FROM l LEFT JOIN r ON l.k = r.k "
        "GROUP BY l.k ORDER BY l.k"),
    "except": ([], "SELECT k FROM l EXCEPT SELECT k FROM r"),
    "except_all_bag_semantics": (
        _BAGS + ["INSERT INTO a VALUES (1), (1), (1), (2)",
                 "INSERT INTO b VALUES (1), (3)"],
        "SELECT v FROM a EXCEPT ALL SELECT v FROM b"),
    "intersect": ([], "SELECT k FROM l INTERSECT SELECT k FROM r"),
    "intersect_all": (
        _BAGS + ["INSERT INTO a VALUES (1), (1), (2)",
                 "INSERT INTO b VALUES (1), (1), (1)"],
        "SELECT v FROM a INTERSECT ALL SELECT v FROM b"),
    "except_chain_left_associative": (
        _BAGS + ["CREATE TABLE c(v INT)", "INSERT INTO a VALUES (1), (2), (3)",
                 "INSERT INTO b VALUES (2)", "INSERT INTO c VALUES (3)"],
        "SELECT v FROM a EXCEPT SELECT v FROM b EXCEPT SELECT v FROM c"),
    "union_still_works": ([], "SELECT k FROM l UNION SELECT k FROM r"),
    "except_with_strings": (
        ["CREATE TABLE sa(s VARCHAR(8))", "CREATE TABLE sb(s VARCHAR(8))",
         'INSERT INTO sa VALUES ("x"), ("y"), ("z")',
         'INSERT INTO sb VALUES ("y")'],
        "SELECT s FROM sa EXCEPT SELECT s FROM sb"),
}


def _rows(res):
    return [tuple(r) for r in res.rows()]


def _types(res):
    return [c.sqltype.name for c in res.table.columns.values()]


def _same(js, ts, sql):
    """Port == JAX: names, SQL types, row order and values (NULLs as
    None)."""
    jr, tr = js.execute(sql), ts.execute(sql)
    assert tr.column_names() == jr.column_names(), sql
    assert _types(tr) == _types(jr), sql
    assert _rows(tr) == _rows(jr), sql


def _both(statements):
    js, ts = aquery2_tpu.connect(), aquery2_tpu_torch.connect(device="cpu")
    for st in statements:
        js.execute(st)
        ts.execute(st)
    return js, ts


@pytest.mark.parametrize("name", sorted(OUTER_SET_OPS))
def test_outer_set_ops_cases_match_jax(name):
    extra, sql = OUTER_SET_OPS[name]
    js, ts = _both(_OUTER_SETUP + extra)
    _same(js, ts, sql)


# --- NULLs, strings, floats, chains -------------------------------------

def _jcol(nm, arr):
    if isinstance(arr, tuple):                  # (codes, strings)
        codes, strs = arr
        return JColumn(nm, JT.StrT, codes, dictionary=JStringDict(strs))
    valid = None
    if isinstance(arr, np.ma.MaskedArray):
        valid = ~np.ma.getmaskarray(arr)
        arr = arr.filled(0)
    return JColumn(nm, JT.from_np_dtype(arr.dtype), arr, valid=valid)


@pytest.fixture(scope="module")
def sessions():
    """p and q: overlapping bags of (int, string, float) rows with NULLs,
    q's strings in a dictionary of its own (other codes, other order)."""
    rng = np.random.default_rng(11)
    strs_p = ["a", "b", "c", "d"]
    strs_q = ["d", "c", "e", "a"]

    def bag(n, strs, seed):
        r = np.random.default_rng(seed)
        return {
            "i": np.ma.masked_array(r.integers(0, 4, n).astype(np.int32),
                                    mask=r.random(n) < 0.15),
            "s": (r.integers(0, len(strs), n).astype(np.int32), strs),
            "f": np.ma.masked_array(
                r.choice([0.5, -0.0, 0.0, 2.25], n).astype(np.float64),
                mask=r.random(n) < 0.1),
        }
    tables = {"p": bag(300, strs_p, 1), "q": bag(200, strs_q, 2),
              "w": {"g": rng.integers(0, 5, 400).astype(np.int32),
                    "v": rng.integers(0, 6, 400).astype(np.int32)}}
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    for name, cols in tables.items():
        ref = JTable(name, [_jcol(nm, a) for nm, a in cols.items()])
        js.catalog.create(ref, replace=True)
        ts.catalog.create(TTable.from_reference(ref, device="cpu"),
                          replace=True)
    return js, ts


SET_CASES = {
    "except_nulls_strings": "SELECT i, s FROM p EXCEPT SELECT i, s FROM q",
    "except_all_three_cols": "SELECT i, s, f FROM p EXCEPT ALL "
                             "SELECT i, s, f FROM q",
    "intersect_three_cols": "SELECT i, s, f FROM p INTERSECT "
                            "SELECT i, s, f FROM q",
    "intersect_all_strings": "SELECT s FROM p INTERSECT ALL SELECT s FROM q",
    "except_negative_zero": "SELECT f FROM p EXCEPT SELECT f FROM q "
                            "WHERE f < 0.1",
    "chain_except_intersect": "SELECT i FROM p EXCEPT SELECT i FROM q "
                              "WHERE i > 2 INTERSECT SELECT i FROM q",
    "chain_intersect_all_except_all": "SELECT s, i FROM p INTERSECT ALL "
                                      "SELECT s, i FROM q EXCEPT ALL "
                                      "SELECT s, i FROM q WHERE i = 1",
    "except_empty_right": "SELECT i, s FROM p EXCEPT SELECT i, s FROM q "
                          "WHERE i > 100",
    "union_distinct": "SELECT i, s FROM p UNION SELECT i, s FROM q",
    "union_mixed": "SELECT i FROM p UNION ALL SELECT i FROM q UNION "
                   "SELECT i FROM p",
    "union_order_limit": "SELECT s, i FROM p UNION SELECT s, i FROM q "
                         "ORDER BY s, i LIMIT 7",
    "distinct_star": "SELECT DISTINCT * FROM p",
    "distinct_union": "SELECT DISTINCT i FROM p UNION ALL SELECT i FROM q",
    "distinct_aggregate_rows": "SELECT DISTINCT count(*) AS c FROM p",
    "distinct_literal": "SELECT DISTINCT 1 AS one, i FROM p",
    "set_op_of_groups": "SELECT g, sum(v) AS s FROM w GROUP BY g EXCEPT "
                        "SELECT g, sum(v) AS s FROM w WHERE v < 5 GROUP BY g",
}


@pytest.mark.parametrize("name", sorted(SET_CASES))
def test_set_operations_match_jax(name, sessions):
    js, ts = sessions
    _same(js, ts, SET_CASES[name])


def test_set_operations_match_nan_with_nan():
    """SQL compares NaN equal to NaN in EXCEPT, INTERSECT and DISTINCT;
    the JAX package's Python tuples never match two NaN floats."""
    ts = aquery2_tpu_torch.connect(device="cpu")
    nan = float("nan")
    for name, vals in (("a", [1.0, nan, nan, 2.0, -0.0]),
                       ("b", [nan, 0.0, 3.0])):
        ts.catalog.create(TTable.from_numpy(
            name, {"v": np.array(vals)}, device="cpu"))

    def got(sql):
        return [None if v != v else v for (v,) in ts.execute(sql).rows()]
    assert got("SELECT v FROM a EXCEPT SELECT v FROM b") == [1.0, 2.0]
    assert got("SELECT v FROM a INTERSECT SELECT v FROM b") == [None, -0.0]
    assert got("SELECT v FROM a EXCEPT ALL SELECT v FROM b") == [1.0, None,
                                                                  2.0]
    assert got("SELECT v FROM a INTERSECT ALL SELECT v FROM b") == [None,
                                                                     -0.0]
    assert got("SELECT v FROM a UNION SELECT v FROM b") == [-0.0, 1.0, 2.0,
                                                             3.0, None]


def test_set_operations_refuse_what_the_jax_package_refuses(sessions):
    _js, ts = sessions
    with pytest.raises(TE.ExecError, match="equal column counts"):
        ts.execute("SELECT i, s FROM p EXCEPT SELECT i FROM q")


# --- DISTINCT aggregates: held to numpy ----------------------------------

def _numpy_distinct(g, x, ok):
    """{group: (count, sum, avg)} of each group's distinct non-NULL x."""
    out = {}
    for k in np.unique(g):
        u = np.unique(x[(g == k) & ok])
        out[int(k)] = (len(u), u.sum(), u.mean() if len(u) else 0.0)
    return out


@pytest.mark.parametrize("col", ["v", "i", "f"])
def test_distinct_aggregates_match_numpy(col, sessions):
    """count, sum and avg(DISTINCT x), grouped and ungrouped, with NULLs
    skipped; min and max(DISTINCT x) equal their plain forms."""
    _js, ts = sessions
    table = "w" if col == "v" else "p"
    key = "g" if col == "v" else "s"
    t = ts.catalog.get(table)
    c = t.columns[col]
    x = c.to_numpy()
    ok = np.ones(len(x), bool) if c.valid is None \
        else c.valid[:t.nrows].numpy()
    g = t.columns[key].to_numpy()
    r = ts.execute(f"SELECT {key}, count(DISTINCT {col}) AS c, "
                   f"sum(DISTINCT {col}) AS sd, avg(DISTINCT {col}) AS a, "
                   f"min(DISTINCT {col}) AS mn, max({col}) AS mx "
                   f"FROM {table} GROUP BY {key}")
    want = _numpy_distinct(g, x, ok)
    cols = r.table.columns
    keys = cols[key].to_numpy()
    assert sorted(keys.tolist()) == sorted(want)
    for j, k in enumerate(keys.tolist()):
        cnt, s, a = want[k]
        assert cols["c"].to_numpy()[j] == cnt
        np.testing.assert_allclose(cols["sd"].to_numpy()[j], s, rtol=1e-15)
        np.testing.assert_allclose(cols["a"].to_numpy()[j], a, rtol=1e-15)
        vals = x[(g == k) & ok]
        assert cols["mn"].to_numpy()[j] == vals.min()
        assert cols["mx"].to_numpy()[j] == vals.max()
    u = np.unique(x[ok])
    row = ts.execute(f"SELECT count(DISTINCT {col}), sum(DISTINCT {col}), "
                     f"avg(DISTINCT {col}), count({col}) FROM {table}").rows()
    assert row[0][0] == len(u) and row[0][3] == int(ok.sum())
    np.testing.assert_allclose(row[0][1:3], [u.sum(), u.mean()], rtol=1e-15)


def test_distinct_aggregate_of_the_reference_example():
    """ROADMAP queue 3's example: over (a, b) = (1,2), (1,2), (1,3), (2,5),
    (2,5) SQL gives count(DISTINCT b) 2 and 1, sum(DISTINCT b) 5 and 5 and
    ungrouped count(DISTINCT b) 3 (the JAX package: 3, 2; 7, 10; 5)."""
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.execute("CREATE TABLE t(a INT, b INT)")
    ts.execute("INSERT INTO t VALUES (1,2),(1,2),(1,3),(2,5),(2,5)")
    assert ts.execute("SELECT a, count(DISTINCT b), sum(DISTINCT b) FROM t "
                      "GROUP BY a").rows() == [(1, 2, 5), (2, 1, 5)]
    assert ts.execute("SELECT count(DISTINCT b) FROM t").rows() == [(3,)]
    with pytest.raises(EvalError, match="distinct_count"):
        ts.execute("SELECT distinct_count(b) FROM t")
