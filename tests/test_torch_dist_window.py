"""The port's mesh session on OVER windows (engine/dist_window.py): every
statement of tests/test_dist_window.py and the OVER statement of
tests/test_multihost.py, in one 4-rank gloo world, against the JAX
package's connect(mesh=4) session: the same rows (integers and strings
exactly, floats within rtol 1e-9), the same names and the same
dist_spmd / dist_fallback counts and reasons. A NULL partition key
falls back as in the JAX package, and its rows are held to numpy.
"""

import numpy as np
import pytest

import torch_dist_world as W

RTOL = 1e-9


def _rows_f():
    rng = np.random.default_rng(77)
    n = 8 * 500
    return [(int(a), int(b), int(t), float(x)) for a, b, t, x in zip(
        rng.integers(1, 8, n), rng.integers(1, 30, n),
        rng.permutation(n), rng.random(n).round(5))]


def _rows_g():
    rng = np.random.default_rng(5)
    return [(f"id{int(a)}", int(b)) for a, b in zip(
        rng.integers(1, 6, 4000), rng.integers(0, 100, 4000))]


def _rows_wf():
    rng = np.random.default_rng(13)
    n = 8 * 400
    return [(int(a), int(b), int(t), float(x)) for a, b, t, x in zip(
        rng.integers(0, 100_000, n), rng.integers(0, 100_000, n),
        rng.permutation(n), rng.random(n).round(5))]


def _rows_nf():
    rng = np.random.default_rng(21)
    n = 8 * 400
    k = rng.integers(1, 7, n)
    ts = rng.permutation(n)
    v = [None if x % 6 == 0 else float(x % 97) / 7
         for x in rng.integers(0, 1000, n)]
    return [(int(a), int(t), x) for a, t, x in zip(k, ts, v)]


NG = [(1, 1.5), (None, 2.5), (1, 3.5), (2, 0.5)]


def _multihost():
    """tests/test_multihost.py's t."""
    rng = np.random.default_rng(99)
    n = 8 * 400
    return rng.integers(1, 9, n), rng.integers(1, 100, n)


def _put(db, ddl, rows):
    db.execute(ddl)
    name = ddl.split()[2].split("(")[0]
    db.catalog.get(name).append_rows(rows)
    db.place_table(db.catalog.get(name))


def load(db):
    _put(db, "CREATE TABLE f(k INT, b INT, ts INT, v DOUBLE)", _rows_f())
    _put(db, "CREATE TABLE g(name VARCHAR(8), x INT)", _rows_g())
    _put(db, "CREATE TABLE wf(k1 INT, k2 INT, ts INT, v DOUBLE)", _rows_wf())
    _put(db, "CREATE TABLE nf(k INT, ts INT, v DOUBLE)", _rows_nf())
    _put(db, "CREATE TABLE ng(k INT, v DOUBLE)", NG)
    k, v = _multihost()
    _put(db, "CREATE TABLE t(k INT, v INT)",
         [(int(a), int(b)) for a, b in zip(k, v)])
    _put(db, "CREATE TABLE one(k INT, ts INT, v DOUBLE)",
         [(7, (i * 37) % 100, float(i % 13) / 4) for i in range(100)])


QUERIES = [
    # tests/test_dist_window.py SPMD_QUERIES
    "SELECT k, sum(v) OVER (PARTITION BY k) AS s FROM f ORDER BY k "
    "LIMIT 20",
    "SELECT k, min(v) OVER (PARTITION BY k) AS mn, "
    "max(b) OVER (PARTITION BY k) AS mx FROM f ORDER BY k LIMIT 16",
    "SELECT k, count(*) OVER (PARTITION BY k) AS c, "
    "stddev(v) OVER (PARTITION BY k) AS sd FROM f WHERE b > 5 "
    "ORDER BY k LIMIT 16",
    "SELECT k, ts, sum(v) OVER (PARTITION BY k ORDER BY ts) AS rs "
    "FROM f ORDER BY k, ts LIMIT 25",
    "SELECT k, avg(v) OVER (PARTITION BY k ORDER BY ts "
    "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS ma FROM f "
    "ORDER BY k, ma LIMIT 20",
    "SELECT k, var(v) OVER (PARTITION BY k ORDER BY ts "
    "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS vv FROM f "
    "ORDER BY k, vv LIMIT 20",
    "SELECT k, sum(v) OVER (PARTITION BY k ORDER BY ts "
    "ROWS BETWEEN UNBOUNDED PRECEDING AND 1 FOLLOWING) AS s2 FROM f "
    "ORDER BY k, ts LIMIT 20",
    "SELECT k, row_number() OVER (PARTITION BY k ORDER BY ts) AS rn "
    "FROM f ORDER BY k, rn LIMIT 25",
    "SELECT k, rank() OVER (PARTITION BY k ORDER BY b) AS r, "
    "dense_rank() OVER (PARTITION BY k ORDER BY b) AS dr FROM f "
    "ORDER BY k, r LIMIT 30",
    "SELECT k, percent_rank() OVER (PARTITION BY k ORDER BY b) AS pr, "
    "cume_dist() OVER (PARTITION BY k ORDER BY b) AS cd FROM f "
    "ORDER BY k, pr LIMIT 20",
    "SELECT k, ntile(4) OVER (PARTITION BY k ORDER BY ts) AS nt FROM f "
    "ORDER BY k, ts LIMIT 20",
    "SELECT k, lag(v) OVER (PARTITION BY k ORDER BY ts) AS pv FROM f "
    "ORDER BY k, ts LIMIT 20",
    "SELECT k, lead(b, 2, -1) OVER (PARTITION BY k ORDER BY ts) AS nb "
    "FROM f ORDER BY k, ts LIMIT 20",
    "SELECT k, first_value(v) OVER (PARTITION BY k ORDER BY ts) AS fv, "
    "last_value(v) OVER (PARTITION BY k) AS lv FROM f "
    "ORDER BY k, ts LIMIT 20",
    "SELECT b, nth_value(v, 3) OVER (PARTITION BY k ORDER BY ts) AS n3 "
    "FROM f ORDER BY b, n3 LIMIT 20",
    # the string partition key, and the window without PARTITION BY
    "SELECT name, sum(x) OVER (PARTITION BY name) AS s FROM g "
    "ORDER BY name LIMIT 12",
    "SELECT sum(b) OVER () AS t FROM f LIMIT 3",
    # WIDE_WINDOW_QUERIES: keys past one packed word, a computed key
    "SELECT k1, k2, sum(v) OVER (PARTITION BY k1, k2 ORDER BY ts) AS rs "
    "FROM wf ORDER BY k1, k2, ts LIMIT 30",
    "SELECT k1, row_number() OVER (PARTITION BY k1 % 5 ORDER BY ts) "
    "AS rn FROM wf ORDER BY k1, rn LIMIT 25",
    # NULL_WINDOW_QUERIES: nullable arguments and row projections
    "SELECT k, sum(v) OVER (PARTITION BY k ORDER BY ts) AS rs "
    "FROM nf ORDER BY k, ts LIMIT 30",
    "SELECT k, avg(v) OVER (PARTITION BY k ORDER BY ts "
    "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS ma FROM nf "
    "ORDER BY k, ts LIMIT 25",
    "SELECT k, count(v) OVER (PARTITION BY k) AS c FROM nf "
    "ORDER BY k, ts LIMIT 20",
    "SELECT k, min(v) OVER (PARTITION BY k ORDER BY ts "
    "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS mn FROM nf "
    "ORDER BY k, ts LIMIT 25",
    "SELECT k, lag(v) OVER (PARTITION BY k ORDER BY ts) AS pv "
    "FROM nf ORDER BY k, ts LIMIT 30",
    "SELECT k, first_value(v) OVER (PARTITION BY k ORDER BY ts) AS fv "
    "FROM nf ORDER BY k, ts LIMIT 25",
    "SELECT k, v, row_number() OVER (PARTITION BY k ORDER BY ts) AS rn "
    "FROM nf ORDER BY k, rn LIMIT 30",
    # tests/test_multihost.py's OVER: the default RANGE frame's peers
    "SELECT k, v, sum(v) OVER (PARTITION BY k ORDER BY v) AS rs FROM t",
    # one partition (three ranks receive no row), and a WHERE that keeps
    # no row
    "SELECT ts, sum(v) OVER (PARTITION BY k ORDER BY ts) AS rs, "
    "rank() OVER (PARTITION BY k ORDER BY v) AS r FROM one",
    "SELECT k, sum(v) OVER (PARTITION BY k) AS s FROM f WHERE v > 2",
]

# a NULL partition key: the gathered path, held to numpy (ROADMAP queue 3
# names the NULL keys inside OVER a known difference)
NULL_KEY = ("SELECT k, sum(v) OVER (PARTITION BY k) AS s FROM ng "
            "ORDER BY v LIMIT 4")


def extra(db):
    return {"null_key": W._record(db, NULL_KEY)}


@pytest.fixture(scope="module")
def runs():
    port, more = W.run_world(load, QUERIES, extra, timeout_s=200)
    return port, more, W.reference(load, QUERIES + [NULL_KEY])


@pytest.mark.parametrize("i", range(len(QUERIES)),
                         ids=[q[:60] for q in QUERIES])
def test_mesh_matches_jax_mesh(runs, i):
    port, _more, ref = runs
    W.assert_same(port[i], ref[i], QUERIES[i], rtol=RTOL)


def test_every_window_runs_on_the_mesh(runs):
    """Each window of the JAX tests runs SPMD in the port but the global
    window, which falls back with the JAX package's reason."""
    port, _more, _ref = runs
    bail = QUERIES.index("SELECT sum(b) OVER () AS t FROM f LIMIT 3")
    for i, rec in enumerate(port):
        want = ((0, 1, ["window without PARTITION BY"]) if i == bail
                else (1, 0, []))
        assert (rec["spmd"], rec["fallback"], rec["reasons"]) == want, \
            (QUERIES[i], rec)


def test_nullable_partition_key_falls_back_to_numpy(runs):
    _port, more, ref = runs
    rec = more["null_key"]
    assert (rec["spmd"], rec["fallback"], rec["reasons"]) == \
        (ref[-1]["spmd"], ref[-1]["fallback"], ref[-1]["reasons"]) == \
        (0, 1, ["NULL-able window key/order/filter columns"])
    sums: dict = {}
    for k, v in NG:
        sums[k] = sums.get(k, 0.0) + v
    want = sorted(((k, sums[k], v) for k, v in NG), key=lambda r: r[2])
    assert rec["rows"] == [(k, s) for k, s, _v in want]


def test_running_sums_match_numpy(runs):
    """tests/test_multihost.py's oracle of the peers' running sum, over
    every row (the port returns them in input order)."""
    port, _more, _ref = runs
    k, v = _multihost()
    rows = port[QUERIES.index("SELECT k, v, sum(v) OVER (PARTITION BY k "
                              "ORDER BY v) AS rs FROM t")]["rows"]
    assert [(a, b) for a, b, _s in rows] == list(zip(k.tolist(),
                                                      v.tolist()))
    for kk, vv, rs in rows:
        assert rs == int(v[(k == kk) & (v <= vv)].sum()), (kk, vv, rs)
