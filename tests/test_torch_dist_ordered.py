"""The port's mesh session on the median and the ordered (ASSUMING)
group-bys (engine/dist_ordered.py): every statement of
tests/test_dist_ordered.py and the median, subvec and ASSUMING sums
statements of tests/test_multihost.py, in one 4-rank gloo world, against
the JAX package's connect(mesh=4) session: the same rows (integers and
strings exactly, floats within rtol 1e-9), the same names and the same
dist_spmd / dist_fallback counts and reasons. The median over a nullable
column, a known reference fault (ROADMAP queue 3), is held to numpy
instead; so are the JAX tests' own oracles.
"""

import numpy as np
import pytest

import torch_dist_world as W

RTOL = 1e-9


def _rows_o():
    rng = np.random.default_rng(21)
    n = 8 * 700
    return [(int(a), int(b), int(t), float(x)) for a, b, t, x in zip(
        rng.integers(1, 11, n), rng.integers(1, 16, n),
        rng.permutation(n), rng.random(n).round(5))]


def _rows_sv():
    rng = np.random.default_rng(5)
    syms = ["aa", "bb", "cc", "dd"]
    n = 8 * 300
    return [(syms[int(i)], float(x)) for i, x in
            zip(rng.integers(0, 4, n), rng.random(n).round(5))]


def _rows_on():
    rng = np.random.default_rng(31)
    n = 8 * 600
    k = rng.integers(1, 9, n)
    t = rng.permutation(n)
    v = rng.random(n).round(5)
    nv = rng.integers(1, 100, n)
    null_nv = rng.random(n) < 0.3
    return [(int(kk), int(tt), float(vv),
             None if nn or kk == 8 else int(xx))
            for kk, tt, vv, nn, xx in zip(k, t, v, null_nv, nv)]


def _rows_w():
    rng = np.random.default_rng(17)
    n = 8 * 500
    k1 = rng.integers(0, 100_000, n)
    k2 = rng.integers(0, 100_000, n) // 9999      # ~11 distinct
    t = rng.permutation(n)
    v = rng.random(n).round(5)
    return [(int(a), int(b), int(tt), float(x))
            for a, b, tt, x in zip(k1, k2, t, v)]


def _multihost():
    """tests/test_multihost.py's t and tr."""
    rng = np.random.default_rng(99)
    n = 8 * 400
    k = rng.integers(1, 9, n)
    v = rng.integers(1, 100, n)
    # the draws its tables t2 and sv take in between
    rng.integers(1, 6, n), rng.integers(1, 6, n), rng.integers(1, 50, n)
    rng.integers(0, 4, n)
    ts = rng.permutation(n)
    return k, v, ts


def _put(db, ddl, rows):
    db.execute(ddl)
    name = ddl.split()[2].split("(")[0]
    db.catalog.get(name).append_rows(rows)
    db.place_table(db.catalog.get(name))


def load(db):
    _put(db, "CREATE TABLE o(id4 INT, id5 INT, ts INT, v3 DOUBLE)", _rows_o())
    _put(db, "CREATE TABLE sv(sym VARCHAR(4), price DOUBLE)", _rows_sv())
    _put(db, "CREATE TABLE on_(id4 INT, ts INT, v3 DOUBLE, nv INT)",
         _rows_on())
    _put(db, "CREATE TABLE w(k1 INT, k2 INT, ts INT, v DOUBLE)", _rows_w())
    k, v, ts = _multihost()
    _put(db, "CREATE TABLE t(k INT, v INT)",
         [(int(a), int(b)) for a, b in zip(k, v)])
    _put(db, "CREATE TABLE tr(k INT, ts INT, v INT)",
         [(int(a), int(b), int(c)) for a, b, c in zip(k, ts, v)])
    _put(db, "CREATE TABLE one(k INT, ts INT, v DOUBLE)", ONE)


# one group: three of the four ranks receive no row
ONE = [(7, (i * 37) % 100, float(i % 13) / 4) for i in range(100)]


QUERIES = [
    # tests/test_dist_ordered.py QUERIES: h2o q6 (median + stddev, two
    # keys), q8 (top-2 under ASSUMING DESC), running and windowed rows
    "SELECT id4, id5, median(v3) AS med, stddev(v3) AS sd FROM o "
    "GROUP BY id4, id5",
    "SELECT id4, median(v3) FROM o WHERE v3 > 0.25 GROUP BY id4",
    "SELECT id4, subvec(v3, 0, 2) AS largest2 FROM o "
    "ASSUMING DESC v3 GROUP BY id4",
    "SELECT id4, max(sums(v3)) FROM o ASSUMING ASC ts GROUP BY id4",
    "SELECT id4, avgs(3, v3) FROM o ASSUMING ASC ts GROUP BY id4",
    "SELECT id4, mins(v3), deltas(v3) FROM o ASSUMING ASC ts GROUP BY id4",
    # the median and subvec oracles' statements, and the string key
    "SELECT id4, median(v3) FROM o GROUP BY id4",
    "SELECT id4, subvec(v3, 0, 2) FROM o ASSUMING DESC v3 GROUP BY id4",
    "SELECT sym, subvec(price, 0, 2) FROM sv ASSUMING DESC price "
    "GROUP BY sym",
    # NULL_QUERIES: nullable aggregate arguments ride the shuffle
    "SELECT id4, median(v3), sum(nv), avg(nv), count(nv) FROM on_ "
    "GROUP BY id4",
    "SELECT id4, subvec(v3, 0, 2), sum(nv), max(nv) FROM on_ "
    "ASSUMING DESC v3 GROUP BY id4",
    "SELECT id4, avgs(3, v3), avg(nv) FROM on_ ASSUMING ASC ts GROUP BY id4",
    # BAIL_QUERIES (the nullable ASSUMING column; the nullable median
    # argument is MEDIAN_NULL below)
    "SELECT id4, sum(v3) FROM on_ ASSUMING ASC nv GROUP BY id4",
    # WIDE_QUERIES: keys past one packed word, computed keys
    "SELECT k2, k1 % 7 AS kb, median(v) FROM w GROUP BY k2, k1 % 7",
    "SELECT k1 % 5 AS kg, median(v), sum(v) FROM w GROUP BY k1 % 5",
    "SELECT k1, k2, subvec(v, 0, 2) FROM w ASSUMING DESC v GROUP BY k1, k2",
    "SELECT k1, k2, avgs(2, v) FROM w ASSUMING ASC ts GROUP BY k1, k2",
    # tests/test_multihost.py: median, subvec, running sums
    "SELECT k, median(v) FROM t GROUP BY k ORDER BY k",
    "SELECT k, subvec(v, 0, 2) AS top2 FROM t ASSUMING DESC v GROUP BY k",
    "SELECT k, sums(v) AS s FROM tr ASSUMING ASC ts GROUP BY k",
    # ranks that receive no row, and a WHERE that keeps none
    "SELECT k, median(v), count(*) FROM one GROUP BY k",
    "SELECT k, avgs(2, v), subvec(v, 1, 3) FROM one ASSUMING ASC ts "
    "GROUP BY k",
    "SELECT id4, median(v3) FROM o WHERE v3 > 2 GROUP BY id4",
    "SELECT id4, sums(v3) FROM o WHERE v3 > 2 ASSUMING ASC ts GROUP BY id4",
]

# the nullable median argument: the JAX package's gathered answer sorts
# the NULL rows in as zeros (ROADMAP queue 3), so numpy holds the rows
MEDIAN_NULL = "SELECT id4, median(nv) FROM on_ GROUP BY id4"


def extra(db):
    return {"median_null": W._record(db, MEDIAN_NULL)}


@pytest.fixture(scope="module")
def runs():
    port, more = W.run_world(load, QUERIES, extra, timeout_s=200)
    return port, more, W.reference(load, QUERIES + [MEDIAN_NULL])


@pytest.mark.parametrize("i", range(len(QUERIES)),
                         ids=[q[:60] for q in QUERIES])
def test_mesh_matches_jax_mesh(runs, i):
    port, _more, ref = runs
    W.assert_same(port[i], ref[i], QUERIES[i], rtol=RTOL)


def test_every_ordered_statement_runs_on_the_mesh(runs):
    """The JAX tests' SPMD statements stay SPMD in the port; the one
    bail falls back with the first reason the JAX package notes (the
    grouped tier's plan declines ASSUMING before the ordered tier's NULL
    gate)."""
    port, _more, _ref = runs
    bail = QUERIES.index(
        "SELECT id4, sum(v3) FROM on_ ASSUMING ASC nv GROUP BY id4")
    for i, rec in enumerate(port):
        want = ((0, 1, ["unsupported shape: clause mix"]) if i == bail
                else (1, 0, []))
        assert (rec["spmd"], rec["fallback"], rec["reasons"]) == want, \
            (QUERIES[i], rec)


def test_nullable_median_argument_falls_back_to_numpy(runs):
    _port, more, ref = runs
    rec = more["median_null"]
    assert (rec["spmd"], rec["fallback"], rec["reasons"]) == \
        (ref[-1]["spmd"], ref[-1]["fallback"], ref[-1]["reasons"]) == \
        (0, 1, ["nullable median argument"])
    rows = _rows_on()
    want = {}
    for k in sorted({r[0] for r in rows}):
        vals = [r[3] for r in rows if r[0] == k and r[3] is not None]
        # an all-NULL group (id4 = 8) reads 0.0, the engine's value for an
        # aggregate over no values (as its sum reads 0)
        want[k] = float(np.median(vals)) if vals else 0.0
    assert {k: m for k, m in rec["rows"]} == want


def _col(rows, j):
    return np.array([r[j] for r in rows])


def test_median_and_subvec_oracles(runs):
    """tests/test_dist_ordered.py's and tests/test_multihost.py's numpy
    oracles, against the port's rows."""
    port, _more, _ref = runs
    o = _rows_o()
    k, v = _col(o, 0), _col(o, 3)
    got = dict(port[QUERIES.index(
        "SELECT id4, median(v3) FROM o GROUP BY id4")]["rows"])
    assert got == {int(kk): float(np.median(v[k == kk]))
                   for kk in np.unique(k)}
    for kk, top2 in port[QUERIES.index(
            "SELECT id4, subvec(v3, 0, 2) FROM o ASSUMING DESC v3 "
            "GROUP BY id4")]["rows"]:
        assert list(top2) == np.sort(v[k == kk])[::-1][:2].tolist()
    mk, mv, ts = _multihost()
    assert port[QUERIES.index(
        "SELECT k, median(v) FROM t GROUP BY k ORDER BY k")]["rows"] == \
        [(int(a), float(np.median(mv[mk == a]))) for a in np.unique(mk)]
    assert port[QUERIES.index(
        "SELECT k, subvec(v, 0, 2) AS top2 FROM t ASSUMING DESC v "
        "GROUP BY k")]["rows"] == \
        [(int(a), np.sort(mv[mk == a])[::-1][:2].tolist())
         for a in np.unique(mk)]
    assert port[QUERIES.index(
        "SELECT k, sums(v) AS s FROM tr ASSUMING ASC ts GROUP BY k")][
            "rows"] == \
        [(int(a), np.cumsum(mv[mk == a][np.argsort(ts[mk == a],
                                                   kind="stable")]).tolist())
         for a in np.unique(mk)]
