"""The port's mesh session on grouped and ungrouped SQL: the queries of
tests/test_dist_sql.py (the single-table part), tests/test_dist_nulls_
strings.py and tests/test_multihost.py (its median, ASSUMING and OVER
statements are in test_torch_dist_ordered.py and test_torch_dist_window.py),
in one 4-rank gloo world, against the JAX
package's connect(mesh=4) session: the same rows (integers exactly,
floats within rtol 1e-12) and the same dist_spmd / dist_fallback counts
and reasons. NULL group keys, a known reference fault (ROADMAP queue 3),
are held to numpy instead.
"""

import numpy as np
import pytest

import torch_dist_world as W


def _rows_g():
    rng = np.random.default_rng(42)
    n = 8 * 600
    cols = [rng.integers(1, 11, n), rng.integers(1, 11, n),
            rng.integers(1, n // 10 + 2, n), rng.integers(1, 6, n),
            rng.random(n).astype(np.float32)]
    return [(int(a), int(b), int(c), int(d), float(e))
            for a, b, c, d, e in zip(*cols)]


def _rows_n():
    rng = np.random.default_rng(7)
    n = 8 * 500
    k = rng.integers(1, 9, n)
    v = rng.integers(1, 100, n)
    w = rng.random(n).round(4)
    null_v = rng.random(n) < 0.3
    null_w = rng.random(n) < 0.2
    rows = [(int(k[i]), None if null_v[i] else int(v[i]),
             None if null_w[i] else float(w[i])) for i in range(n)]
    return [(kk, None if kk == 8 else vv, ww) for kk, vv, ww in rows]


NK_HEAD = [(1, 10), (None, 5), (None, 7), (1, 3), (2, 4)]
NK_ROWS = [(i % 5 if i % 7 else None, i % 11) for i in range(4000)]


def _rows_s():
    rng = np.random.default_rng(11)
    n = 8 * 400
    syms = ["aapl", "msft", "goog", "nvda", "amzn"]
    si = rng.integers(0, len(syms), n)
    v = rng.integers(1, 50, n)
    return [(syms[si[i]], int(v[i])) for i in range(n)]


def _multihost():
    rng = np.random.default_rng(99)
    n = 8 * 400
    k = rng.integers(1, 9, n)
    v = rng.integers(1, 100, n)
    a2, b2 = rng.integers(1, 6, n), rng.integers(1, 6, n)
    v2 = rng.integers(1, 50, n)
    si = rng.integers(0, 4, n)
    return k, v, a2, b2, v2, si


def _put(db, ddl, rows):
    db.execute(ddl)
    name = ddl.split()[2].split("(")[0]
    db.catalog.get(name).append_rows(rows)
    db.place_table(db.catalog.get(name))


def load(db):
    _put(db, "CREATE TABLE g(id1 INT, id2 INT, id3 INT, v1 INT, v3 FLOAT)",
         _rows_g())
    _put(db, "CREATE TABLE n(k INT, v INT, w DOUBLE)", _rows_n())
    _put(db, "CREATE TABLE nk(a INT, b INT)", NK_HEAD + NK_ROWS)
    _put(db, "CREATE TABLE s(sym VARCHAR(8), v INT)", _rows_s())
    k, v, a2, b2, v2, si = _multihost()
    _put(db, "CREATE TABLE mt(k INT, v INT)",
         [(int(a), int(b)) for a, b in zip(k, v)])
    _put(db, "CREATE TABLE mt2(a INT, b INT, v INT)",
         [(int(x), int(y), int(z)) for x, y, z in zip(a2, b2, v2)])
    _put(db, "CREATE TABLE md(k INT, w INT)",
         [(i, i % 3) for i in range(1, 6)])
    syms = ["aa", "bb", "cc", "dd"]
    _put(db, "CREATE TABLE msv(sym VARCHAR(4), price INT)",
         [(syms[int(i)], int(p)) for i, p in zip(si, v)])


QUERIES = [
    # tests/test_dist_sql.py QUERIES: dense, packed, multikey tiers
    "SELECT id1, sum(v1) FROM g GROUP BY id1 ORDER BY id1",
    "SELECT id1, avg(v3), max(v1) - min(v1) FROM g GROUP BY id1 ORDER BY id1",
    "SELECT id1, id2, sum(v1), count(*) FROM g GROUP BY id1, id2 "
    "ORDER BY id1, id2",
    "SELECT id3, sum(v1) FROM g GROUP BY id3 ORDER BY id3",
    "SELECT id1, count(*) FROM g WHERE v1 > 2 GROUP BY id1 ORDER BY id1",
    "SELECT id1, sum(v1) FROM g GROUP BY id1 HAVING sum(v1) > 0 "
    "ORDER BY id1",
    "SELECT id1 + id2, sum(v1) FROM g GROUP BY id1 + id2 ORDER BY id1 + id2",
    "SELECT id1, var(v1), corr(v1, v3) FROM g GROUP BY id1 ORDER BY id1",
    "SELECT id1, sum(v1) FROM g GROUP BY id1",
    # test_dist_path_accounting's sequence
    "SELECT count(*) FROM g WHERE v1 > 2",
    "SELECT DISTINCT id1 FROM g",
    "SELECT v1, v3 FROM g ORDER BY v3 LIMIT 3",
    "SELECT v1, CASE WHEN v3 > 50 THEN 1 END AS hi FROM g "
    "ORDER BY v1, v3 LIMIT 3",
    # test_dist_ungrouped_aggregates
    "SELECT count(*), sum(v1), min(v1), max(v1) FROM g",
    "SELECT avg(v3), var(v1) FROM g WHERE v1 > 2",
    "SELECT sum(v1) + count(*) FROM g",
    # test_dist_insert_keeps_sharding
    "CREATE TABLE t2(a INT, b INT)",
    "INSERT INTO t2 VALUES (1, 5), (1, 7), (2, 9)",
    "SELECT a, sum(b) FROM t2 GROUP BY a ORDER BY a",
    # tests/test_dist_nulls_strings.py NULL_QUERIES
    "SELECT k, sum(v), count(v), count(*) FROM n GROUP BY k ORDER BY k",
    "SELECT k, avg(v), min(v), max(v) FROM n GROUP BY k ORDER BY k",
    "SELECT k, var(v), corr(v, w) FROM n GROUP BY k ORDER BY k",
    "SELECT k, sum(w), avg(w) FROM n GROUP BY k ORDER BY k",
    "SELECT k + k, sum(v), count(v) FROM n GROUP BY k + k ORDER BY k + k",
    "SELECT k, sum(v), count(v) FROM n GROUP BY k",
    # STR_QUERIES and the string oracle's query
    "SELECT sym, sum(v), count(*) FROM s GROUP BY sym ORDER BY sym",
    "SELECT sym, max(v) - min(v) FROM s GROUP BY sym ORDER BY sym",
    "SELECT sym, avg(v) FROM s WHERE v > 10 GROUP BY sym ORDER BY sym",
    "SELECT sym, sum(v) FROM s GROUP BY sym",
    # tests/test_multihost.py but the median, ASSUMING and OVER
    "SELECT k, sum(v), count(*) FROM mt GROUP BY k ORDER BY k",
    "SELECT a, b, sum(v) FROM mt2 GROUP BY a, b ORDER BY a, b",
    "SELECT count(*), sum(v), max(v) FROM mt",
    "SELECT count(*) FROM mt, md WHERE mt.k = md.k",
    "SELECT mt.k, count(*), sum(md.w) FROM mt JOIN md ON mt.k = md.k "
    "GROUP BY mt.k ORDER BY mt.k",
    "SELECT mt.k, count(*), sum(md.w) FROM mt LEFT JOIN md "
    "ON mt.k = md.k GROUP BY mt.k ORDER BY mt.k",
    "SELECT sym, sum(price), count(*) FROM msv GROUP BY sym ORDER BY sym",
    "SELECT k, v FROM mt ORDER BY v DESC LIMIT 7",
]

# a join's output named as written: the JAX package shows its rewrite
# (``__star_w``, ``__jk``), a known reference fault
NAMES = {
    "SELECT mt.k, count(*), sum(md.w) FROM mt JOIN md ON mt.k = md.k "
    "GROUP BY mt.k ORDER BY mt.k": ["k", "count", "sum_w"],
    "SELECT mt.k, count(*), sum(md.w) FROM mt LEFT JOIN md "
    "ON mt.k = md.k GROUP BY mt.k ORDER BY mt.k": ["k", "count", "sum_w"],
}

# NULL group keys: a known reference fault, held to numpy
NK_QUERY = "SELECT a, sum(b), count(*) FROM nk GROUP BY a ORDER BY a"


def extra(db):
    """What the world reports beside the statements: the placement of g,
    and the stats text."""
    from aquery2_tpu_torch.parallel.mesh import ShardedColumn

    g = db.catalog.get("g")
    blocks = {c.name: (isinstance(c, ShardedColumn), int(c.block.shape[0]),
                       c.capacity) for c in g.columns.values()}
    return {"blocks": blocks,
            "format_says_fallback": "fallback" in db.stats.format().lower(),
            "nk": W._record(db, NK_QUERY)}


@pytest.fixture(scope="module")
def runs():
    port, more = W.run_world(load, QUERIES, extra)
    return port, more, W.reference(load, QUERIES)


@pytest.mark.parametrize("i", range(len(QUERIES)),
                         ids=[q[:60] for q in QUERIES])
def test_mesh_matches_jax_mesh(runs, i):
    port, _more, ref = runs
    W.assert_same(port[i], ref[i], QUERIES[i], names=NAMES.get(QUERIES[i]))


def test_tables_are_sharded(runs):
    """Each rank holds a quarter of every column of g."""
    _port, more, _ref = runs
    for name, (sharded, blk, cap) in more["blocks"].items():
        assert sharded, name
        assert blk * W.WORLD == cap, (name, blk, cap)


def test_fallbacks_show_in_stats(runs):
    _port, more, _ref = runs
    assert more["format_says_fallback"]


def test_nullable_group_key_matches_numpy(runs):
    _port, more, _ref = runs
    rec = more["nk"]
    assert (rec["spmd"], rec["fallback"]) == (1, 0)
    want: dict = {}
    for a, b in NK_HEAD + NK_ROWS:
        s, c = want.get(a, (0, 0))
        want[a] = (s + b, c + 1)
    got = {a: (s, c) for a, s, c in rec["rows"]}
    assert got == want
    assert rec["rows"][0][0] is None         # NULL sorts first ascending


def test_oracles_match_numpy(runs):
    """The exact oracles of the JAX tests, against the port's rows."""
    port, _more, _ref = runs
    rows = _rows_g()
    id1 = np.array([r[0] for r in rows])
    v1 = np.array([r[3] for r in rows], np.int64)
    want = {int(k): int(v1[id1 == k].sum()) for k in np.unique(id1)}
    got = dict(port[QUERIES.index(
        "SELECT id1, sum(v1) FROM g GROUP BY id1")]["rows"])
    assert got == want
    nrows = _rows_n()
    want_n: dict = {}
    for k, v, _w in nrows:
        s, c = want_n.get(k, (0, 0))
        want_n[k] = (s + (v or 0), c + (v is not None))
    got_n = {r[0]: (r[1], r[2]) for r in port[QUERIES.index(
        "SELECT k, sum(v), count(v) FROM n GROUP BY k")]["rows"]}
    assert got_n == want_n and got_n[8] == (0, 0)
