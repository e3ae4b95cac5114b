"""The port's mesh session on joins: the join queries of
tests/test_dist_sql.py (the star join into the distributed group-by, the
count join's histogram and exchange routes under a skewed key, the
materialized join of non-unique build keys) and every query of
tests/test_dist_outer_join.py, in one 4-rank gloo world, against the JAX
package's connect(mesh=4) session: the same rows and the same
dist_spmd / dist_fallback counts and reasons. Output names are held to
the projections as written where the JAX package shows its rewrite
(``__star_w``, ``__jk``: a known reference fault).
"""

from collections import Counter

import numpy as np
import pytest

import torch_dist_world as W


def _join_rows():
    rng = np.random.default_rng(42)
    n = 8 * 600
    fk = rng.integers(1, 400, n)
    fk[: n // 2] = 7                          # heavy-hitter key (skew)
    fv = rng.integers(1, 10, n)
    fact = [(int(k), int(v)) for k, v in zip(fk, fv)]
    dim = [(int(k), int(k % 5 + 1)) for k in range(1, 350)]
    return fact, dim, dim + dim[:40], dim + [(6_000_000, 1)]


def _outer_rows():
    rng = np.random.default_rng(21)
    n = 8 * 400
    rows = [(int(a), int(b), float(x)) for a, b, x in zip(
        rng.integers(1, 30, n), rng.integers(1, 40, n),
        rng.random(n).round(4))]
    dim = [(int(k), int(w)) for k, w in
           zip(range(5, 45), rng.integers(1, 9, 40))]
    return rows, dim


def _put(db, ddl, rows):
    db.execute(ddl)
    name = ddl.split()[2].split("(")[0]
    db.catalog.get(name).append_rows(rows)
    db.place_table(db.catalog.get(name))


def load(db):
    fact, dim, dim_dup, dim_wide = _join_rows()
    _put(db, "CREATE TABLE fact(k INT, v INT)", fact)
    for name, rows in (("dim", dim), ("dim_dup", dim_dup),
                       ("dim_wide", dim_wide)):
        _put(db, f"CREATE TABLE {name}(k INT, w INT)", rows)
    rows, odim = _outer_rows()
    _put(db, "CREATE TABLE f(k INT, b INT, v DOUBLE)", rows)
    _put(db, "CREATE TABLE d(k INT, w INT)", odim)


QUERIES = [
    # tests/test_dist_sql.py JOIN_QUERIES
    "SELECT d.w, count(*), sum(f.v) FROM fact f, dim d "
    "WHERE f.k = d.k GROUP BY d.w ORDER BY d.w",
    "SELECT d.w, max(f.v) - min(f.v) FROM fact f, dim d "
    "WHERE f.k = d.k GROUP BY d.w ORDER BY d.w",
    "SELECT count(*), sum(f.v) FROM fact f, dim d WHERE f.k = d.k",
    "SELECT count(*) FROM fact f, dim_dup d WHERE f.k = d.k",
    "SELECT count(*) FROM fact f, dim_wide d WHERE f.k = d.k",
    # GENERAL_JOIN_QUERIES
    "SELECT d.w, count(*), sum(f.v) FROM fact f, dim_dup d "
    "WHERE f.k = d.k GROUP BY d.w ORDER BY d.w",
    "SELECT sum(f.v), count(*) FROM fact f, dim_dup d "
    "WHERE f.k = d.k AND f.v > 3",
    "SELECT f.k, count(*) FROM fact f, dim_dup d WHERE f.k = d.k "
    "GROUP BY f.k HAVING count(*) > 20 ORDER BY f.k",
    "SELECT d.w, max(f.v) FROM fact f JOIN dim_dup d ON f.k = d.k "
    "GROUP BY d.w ORDER BY d.w",
    # tests/test_dist_outer_join.py SPMD_QUERIES
    "SELECT f.k, count(*), sum(d.w) FROM f LEFT JOIN d ON f.k = d.k "
    "GROUP BY f.k ORDER BY f.k",
    "SELECT count(*), sum(d.w), sum(f.b) FROM f LEFT JOIN d ON f.k = d.k",
    "SELECT d.k, count(*), sum(f.b) FROM f RIGHT JOIN d ON f.k = d.k "
    "GROUP BY d.k ORDER BY d.k",
    "SELECT count(*), sum(f.b), sum(d.w) FROM f FULL JOIN d "
    "ON f.k = d.k",
    "SELECT f.b, count(*), sum(d.w) FROM f LEFT JOIN d ON f.k = d.k "
    "GROUP BY f.b ORDER BY f.b",
    "SELECT f.k, min(d.w), max(d.w), avg(d.w) FROM f LEFT JOIN d "
    "ON f.k = d.k GROUP BY f.k ORDER BY f.k",
    # the outer joins that fall back (residual WHERE, NULL side's key)
    "SELECT f.k, count(*) FROM f LEFT JOIN d ON f.k = d.k "
    "WHERE f.b > 10 GROUP BY f.k ORDER BY f.k",
    "SELECT d.k, count(*) FROM f LEFT JOIN d ON f.k = d.k "
    "GROUP BY d.k ORDER BY d.k",
]

# output names as written (the JAX package shows its rewrite)
NAMES = {
    QUERIES[0]: ["w", "count", "sum_v"],
    QUERIES[1]: ["w", "max_v___min_v"],
    QUERIES[2]: ["count", "sum_v"],
    QUERIES[5]: ["w", "count", "sum_v"],
    QUERIES[6]: ["sum_v", "count"],
    QUERIES[7]: ["k", "count"],
    QUERIES[8]: ["w", "max_v"],
    QUERIES[9]: ["k", "count", "sum_w"],
    QUERIES[10]: ["count", "sum_w", "sum_b"],
    QUERIES[11]: ["k", "count", "sum_b"],
    QUERIES[12]: ["count", "sum_b", "sum_w"],
    QUERIES[13]: ["b", "count", "sum_w"],
    QUERIES[14]: ["k", "min_w", "max_w", "avg_w"],
}


@pytest.fixture(scope="module")
def runs():
    port, _more = W.run_world(load, QUERIES)
    return port, W.reference(load, QUERIES)


@pytest.mark.parametrize("i", range(len(QUERIES)),
                         ids=[q[:60] for q in QUERIES])
def test_mesh_join_matches_jax_mesh(runs, i):
    port, ref = runs
    W.assert_same(port[i], ref[i], QUERIES[i], rtol=1e-12,
                  names=NAMES.get(QUERIES[i]))


def test_join_count_matches_numpy(runs):
    """The exchange route's count under the skewed key, against the
    exact oracle."""
    port, _ref = runs
    fact, _dim, dim_dup, _wide = _join_rows()
    mult = Counter(k for k, _w in dim_dup)
    want = sum(mult[k] for k, _v in fact)
    assert port[3]["rows"] == [(want,)]
