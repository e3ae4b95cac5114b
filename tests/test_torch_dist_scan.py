"""The port's mesh session on scans, set operations and the gathered
fallback: every query of tests/test_dist_scan.py, tests/test_dist_setop.py
and tests/test_mesh_fallback.py, in one 4-rank gloo world, against the
JAX package's connect(mesh=4) session: the same rows and the same
dist_spmd / dist_fallback counts and reasons (a join's output names as
written, where the JAX package shows its rewrite).
"""

import numpy as np
import pytest

import torch_dist_world as W


def _scan_rows():
    rng = np.random.default_rng(42)
    n = 8 * 600
    syms = ["aa", "bb", "cc", "dd"]
    return [(int(k), float(v), int(b), syms[int(s)]) for k, v, b, s in zip(
        rng.integers(1, 50, n), rng.random(n).round(6),
        rng.integers(-100, 100, n), rng.integers(0, 4, n))]


def _setop_rows():
    rng = np.random.default_rng(9)
    n = 8 * 400
    rows = [(int(a), int(b), float(x)) for a, b, x in zip(
        rng.integers(1, 10, n), rng.integers(1, 40, n),
        rng.random(n).round(4))]
    rows2 = [(int(a), int(b), float(x)) for a, b, x in zip(
        rng.integers(5, 14, n), rng.integers(1, 40, n),
        rng.random(n).round(4))]
    rows2[:200] = rows[:200]
    return rows, rows2


def _string_rows():
    rng = np.random.default_rng(3)

    def mk(lo, hi, m):
        return [(f"u{int(x)}", int(y)) for x, y in zip(
            rng.integers(lo, hi, m), rng.integers(0, 5, m))]
    return mk(0, 12, 2000), mk(6, 18, 2000)


def _null_rows():
    rng = np.random.default_rng(5)
    nrows = 8 * 300
    ka = rng.integers(1, 6, nrows)
    ba = [None if x % 7 == 0 else int(x) for x in rng.integers(1, 40, nrows)]
    kb = rng.integers(1, 6, nrows // 2)
    bb = [None if x % 5 == 0 else int(x) for x in
          rng.integers(1, 40, nrows // 2)]
    return ([(int(a), b) for a, b in zip(ka, ba)],
            [(int(a), b) for a, b in zip(kb, bb)])


def _fallback_rows():
    rng = np.random.default_rng(31)
    n = 8 * 500
    return [(int(a), int(b), int(t), float(x)) for a, b, t, x in zip(
        rng.integers(1, 8, n), rng.integers(1, 30, n),
        rng.permutation(n), rng.random(n).round(5))]


def _put(db, ddl, rows):
    db.execute(ddl)
    name = ddl.split()[2].split("(")[0]
    db.catalog.get(name).append_rows(rows)
    db.place_table(db.catalog.get(name))


def load(db):
    _put(db, "CREATE TABLE s(k INT, v DOUBLE, b INT, sym VARCHAR(4))",
         _scan_rows())
    rows, rows2 = _setop_rows()
    _put(db, "CREATE TABLE a(k INT, b INT, v DOUBLE)", rows)
    _put(db, "CREATE TABLE c(k INT, b INT, v DOUBLE)", rows2)
    sa, sb = _string_rows()
    _put(db, "CREATE TABLE sa(name VARCHAR(6), b INT)", sa)
    _put(db, "CREATE TABLE sb(name VARCHAR(6), b INT)", sb)
    na, nb = _null_rows()
    _put(db, "CREATE TABLE na(k INT, b INT)", na)
    _put(db, "CREATE TABLE nb(k INT, b INT)", nb)
    _put(db, "CREATE TABLE f(k INT, b INT, ts INT, v DOUBLE)",
         _fallback_rows())
    _put(db, "CREATE TABLE d(k INT, w INT)",
         [(i, i % 3 + 1) for i in range(1, 9)])


QUERIES = [
    # tests/test_dist_scan.py TOPK_QUERIES and the single-test queries
    "SELECT k, v FROM s ORDER BY v LIMIT 20",
    "SELECT k, v FROM s WHERE v > 0.5 ORDER BY v DESC LIMIT 17",
    "SELECT k, b * 2 AS b2, v FROM s ORDER BY k, v LIMIT 25",
    "SELECT b, v FROM s WHERE k < 25 ORDER BY b DESC, v LIMIT 30",
    "SELECT sym, v FROM s ORDER BY sym, v LIMIT 21",
    "SELECT k, v FROM s LIMIT 10",
    "SELECT k, v FROM s WHERE v > 0.999 ORDER BY v LIMIT 100",
    "SELECT k, v FROM s ORDER BY v LIMIT 2000",
    "SELECT k, v FROM s ORDER BY v LIMIT 9",
    "SELECT k, v FROM s ORDER BY v, k LIMIT 2000",
    "SELECT k, v FROM s ORDER BY v LIMIT 12",
    # tests/test_dist_setop.py
    "SELECT k, b FROM a EXCEPT SELECT k, b FROM c",
    "SELECT k, b FROM a EXCEPT ALL SELECT k, b FROM c",
    "SELECT k, b FROM a INTERSECT SELECT k, b FROM c",
    "SELECT k, b FROM a INTERSECT ALL SELECT k, b FROM c",
    "SELECT k, b, v FROM a EXCEPT SELECT k, b, v FROM c",
    "SELECT k FROM a WHERE b > 15 GROUP BY k "
    "EXCEPT SELECT k FROM a WHERE b < 5 GROUP BY k",
    "SELECT k, count(*) FROM a GROUP BY k "
    "UNION SELECT k, count(*) FROM c GROUP BY k",
    "SELECT k FROM a GROUP BY k UNION SELECT k FROM c GROUP BY k",
    "SELECT name, b FROM sa INTERSECT SELECT name, b FROM sb",
    "SELECT name, b FROM sa EXCEPT SELECT name, b FROM sb",
    "SELECT k, b FROM na EXCEPT SELECT k, b FROM nb",
    "SELECT k, b FROM na EXCEPT ALL SELECT k, b FROM nb",
    "SELECT k, b FROM na INTERSECT SELECT k, b FROM nb",
    "SELECT k, b FROM na INTERSECT ALL SELECT k, b FROM nb",
    # tests/test_mesh_fallback.py: the fallback class, then the SPMD ones
    "SELECT k, CASE WHEN b > 15 THEN 1 END AS hi FROM f "
    "ORDER BY k, b LIMIT 25",
    "SELECT k, CASE WHEN b > 15 THEN 1 END AS hi "
    "FROM f ORDER BY k, b LIMIT 5",
    "SELECT f.b, d.w FROM f, d WHERE f.k = d.k ORDER BY f.b, d.w LIMIT 30",
    "SELECT f.b, d.w FROM f, d WHERE f.k = d.k ORDER BY f.b, d.w",
    "SELECT b, v FROM f WHERE v > 0.8 ORDER BY v, b",
    "SELECT k, b + 1 AS b1 FROM f WHERE v > 0.95 ORDER BY k, b1",
    "SELECT k, CASE WHEN b > 15 THEN 1 ELSE 0 END AS hi FROM f "
    "ORDER BY k, hi, b LIMIT 25",
    "SELECT k, count(*) FROM f WHERE CASE WHEN b > 20 THEN 1 ELSE 0 END"
    " = 1 GROUP BY k ORDER BY k",
    "SELECT k, sum(CASE WHEN b > 15 THEN b ELSE 0 END) FROM f "
    "GROUP BY k ORDER BY k",
    "SELECT k, count(*) FROM f GROUP BY k UNION ALL "
    "SELECT 999, count(*) FROM f",
    "SELECT b, v FROM f WHERE v > 0.9 ORDER BY v LIMIT 15",
    "SELECT DISTINCT k FROM f ORDER BY k",
    "INSERT INTO f VALUES (3, 99, 999991, 0.5), (7, 98, 999992, 0.25)",
    "SELECT k, count(*), sum(b) FROM f GROUP BY k ORDER BY k",
]

NAMES = {
    "SELECT f.b, d.w FROM f, d WHERE f.k = d.k ORDER BY f.b, d.w LIMIT 30":
        ["b", "w"],
    "SELECT f.b, d.w FROM f, d WHERE f.k = d.k ORDER BY f.b, d.w":
        ["b", "w"],
}


# an unaliased CASE: the JAX package names it at random
NAMELESS = {"SELECT k, sum(CASE WHEN b > 15 THEN b ELSE 0 END) FROM f "
            "GROUP BY k ORDER BY k"}


@pytest.fixture(scope="module")
def runs():
    port, _more = W.run_world(load, QUERIES)
    return port, W.reference(load, QUERIES)


@pytest.mark.parametrize("i", range(len(QUERIES)),
                         ids=[q[:60] for q in QUERIES])
def test_mesh_scan_matches_jax_mesh(runs, i):
    port, ref = runs
    q = QUERIES[i]
    names = port[i].get("names") if q in NAMELESS else NAMES.get(q)
    W.assert_same(port[i], ref[i], q, names=names)


def test_topk_matches_numpy(runs):
    """Exact top-k against numpy (ties by row order)."""
    port, _ref = runs
    rows = _scan_rows()
    v = np.array([r[1] for r in rows])
    order = np.lexsort((np.arange(len(rows)), v))[:12]
    want = [(rows[i][0], rows[i][1]) for i in order]
    assert port[QUERIES.index("SELECT k, v FROM s ORDER BY v LIMIT 12")][
        "rows"] == want
