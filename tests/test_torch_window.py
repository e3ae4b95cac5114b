"""OVER windows through both packages: the JAX package
(aquery2_tpu.connect()) and the port (aquery2_tpu_torch.connect("cpu"))
load the same seeded rows and must return the same names and rows, and
the port must match tests/test_window.py's brute-force ``_oracle``; every
case of that file has its counterpart here. Then each function of
ops/window.py against aquery2_tpu.ops.window on seeded flags and values,
the shapes that raise (with the JAX package's messages), windows inside
each tier's query shapes, and NULL order keys, which the port sorts as
its ORDER BY does (first ascending, last descending; the JAX package
puts them last both ways, ROADMAP queue 3), held to numpy.

Integers, ranks, counts and row picks are exact; float results to
FLOAT_TOL absolute, as tests/test_window.py compares them."""

import math

import numpy as np
import pytest
import torch

import aquery2_tpu
import jax.numpy as jnp
from aquery2_tpu.ops import window as JW

import aquery2_tpu_torch
from aquery2_tpu_torch.engine.eval import EvalError
from aquery2_tpu_torch.ops import window as TW

from test_window import FRAMES, _mk, _oracle

FLOAT_TOL = 1e-9


@pytest.fixture
def both():
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    yield js, ts
    js.close()


def _run(both, *stmts):
    for db in both:
        for s in stmts:
            db.execute(s)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None or isinstance(w, str):
            assert g == w, (g, w)
        else:
            assert g is not None and abs(float(g) - float(w)) < FLOAT_TOL, \
                (g, w)


def _same(both, sql):
    """The port's rows of sql, after checking them against the JAX
    package's: names, then every value (floats to FLOAT_TOL)."""
    js, ts = both
    jr, tr = js.execute(sql), ts.execute(sql)
    assert tr.column_names() == jr.column_names(), sql
    trows, jrows = tr.rows(), jr.rows()
    assert len(trows) == len(jrows), sql
    for t, j in zip(trows, jrows):
        _close(t, j)
    return trows


def _last(rows):
    return [r[-1] for r in rows]


# --- the cases of tests/test_window.py ---------------------------------------

@pytest.mark.parametrize("fn", ["sum", "avg", "min", "max", "count", "var",
                                "stddev"])
@pytest.mark.parametrize("fspec", FRAMES, ids=[f[0] or "default"
                                               for f in FRAMES])
def test_frame_aggregates(both, fn, fspec):
    ftext, frame = fspec
    k, t, v, nulls = _mk(both[0])
    _mk(both[1])
    sql = (f"SELECT k, t, {fn}(v) OVER (PARTITION BY k ORDER BY t"
           f"{' ' + ftext if ftext else ''}) AS r FROM w ORDER BY t")
    order = np.argsort(t, kind="stable")
    want = _oracle(k, t, v, nulls, fn, frame)
    _close(_last(_same(both, sql)), [want[i] for i in order])


@pytest.mark.parametrize("fn", ["sum", "avg", "min", "max", "count"])
def test_frame_aggregates_nulls(both, fn):
    k, t, v, nulls = _mk(both[0], with_nulls=True)
    _mk(both[1], with_nulls=True)
    sql = (f"SELECT k, t, {fn}(v) OVER (PARTITION BY k ORDER BY t "
           f"ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) AS r "
           f"FROM w ORDER BY t")
    order = np.argsort(t, kind="stable")
    want = _oracle(k, t, v, nulls, fn, (-2, 1))
    _close(_last(_same(both, sql)), [want[i] for i in order])


def test_count_star_whole_partition(both):
    k, t, v, nulls = _mk(both[0])
    _mk(both[1])
    got = _last(_same(both, "SELECT k, count(*) OVER (PARTITION BY k) AS c "
                            "FROM w ORDER BY t"))
    sizes = {p: int((k == p).sum()) for p in np.unique(k)}
    assert got == [sizes[k[i]] for i in np.argsort(t, kind="stable")]


def test_whole_table_over_empty(both):
    k, t, v, nulls = _mk(both[0])
    _mk(both[1])
    got = _last(_same(both, "SELECT t, sum(v) OVER () AS s FROM w "
                            "ORDER BY t"))
    assert got == [int(v.sum())] * len(t)


def test_row_number_rank_dense_rank(both):
    data = [(1, 10), (1, 10), (1, 20), (1, 30), (1, 30), (1, 30),
            (2, 5), (2, 5), (2, 7)]
    _run(both, "CREATE TABLE r(k INT, s INT)",
         "INSERT INTO r VALUES " + ", ".join(f"({a},{b})" for a, b in data))
    rows = _same(both,
                 "SELECT k, s, row_number() OVER (PARTITION BY k ORDER BY s) "
                 "AS rn, rank() OVER (PARTITION BY k ORDER BY s) AS rk, "
                 "dense_rank() OVER (PARTITION BY k ORDER BY s) AS dr "
                 "FROM r ORDER BY k, s")
    assert rows == [
        (1, 10, 1, 1, 1), (1, 10, 2, 1, 1), (1, 20, 3, 3, 2),
        (1, 30, 4, 4, 3), (1, 30, 5, 4, 3), (1, 30, 6, 4, 3),
        (2, 5, 1, 1, 1), (2, 5, 2, 1, 1), (2, 7, 3, 3, 2)]


def test_percent_rank_cume_dist_ntile(both):
    _run(both, "CREATE TABLE p(s INT)",
         "INSERT INTO p VALUES (10), (20), (20), (30), (40)")
    rows = _same(both, "SELECT s, percent_rank() OVER (ORDER BY s) AS pr, "
                       "cume_dist() OVER (ORDER BY s) AS cd, "
                       "ntile(2) OVER (ORDER BY s) AS nt FROM p ORDER BY s")
    _close([r[1] for r in rows], [0.0, 0.25, 0.25, 0.75, 1.0])
    _close([r[2] for r in rows], [0.2, 0.6, 0.6, 0.8, 1.0])
    assert [r[3] for r in rows] == [1, 1, 1, 2, 2]


def test_lag_lead(both):
    _mk(both[0], n=40)
    _mk(both[1], n=40)
    rows = _same(both,
                 "SELECT k, t, v, lag(v) OVER (PARTITION BY k ORDER BY t) "
                 "AS lg, lead(v, 2) OVER (PARTITION BY k ORDER BY t) AS ld, "
                 "lag(v, 1, -999) OVER (PARTITION BY k ORDER BY t) AS lgd "
                 "FROM w ORDER BY k, t")
    by_part = {}
    for kk, _tt, vv, lg, ld, lgd in rows:
        by_part.setdefault(kk, []).append((vv, lg, ld, lgd))
    for seq in by_part.values():
        vs = [s[0] for s in seq]
        for j, (_vv, lg, ld, lgd) in enumerate(seq):
            assert lg == (vs[j - 1] if j > 0 else None)
            assert ld == (vs[j + 2] if j + 2 < len(vs) else None)
            assert lgd == (vs[j - 1] if j > 0 else -999)


def test_first_last_nth_value(both):
    _mk(both[0], n=30)
    _mk(both[1], n=30)
    rows = _same(both,
                 "SELECT k, v, first_value(v) OVER (PARTITION BY k ORDER BY "
                 "t) AS f, last_value(v) OVER (PARTITION BY k ORDER BY t ROWS "
                 "BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS l, "
                 "nth_value(v, 2) OVER (PARTITION BY k ORDER BY t ROWS "
                 "BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS n2 "
                 "FROM w ORDER BY k, t")
    by_part = {}
    for row in rows:
        by_part.setdefault(row[0], []).append(row)
    for seq in by_part.values():
        vs = [r[1] for r in seq]
        for r in seq:
            assert (r[2], r[3]) == (vs[0], vs[-1])
            assert r[4] == (vs[1] if len(vs) >= 2 else None)


def test_range_default_frame_peers(both):
    _run(both, "CREATE TABLE pk(s INT, v INT)",
         "INSERT INTO pk VALUES (1, 10), (2, 20), (2, 30), (3, 40)")
    assert _last(_same(both, "SELECT s, sum(v) OVER (ORDER BY s) AS r "
                             "FROM pk ORDER BY s, v")) == [10, 60, 60, 100]


def test_rows_current_row_no_peer_smear(both):
    _run(both, "CREATE TABLE pk2(s INT, v INT)",
         "INSERT INTO pk2 VALUES (1, 10), (2, 20), (2, 30), (3, 40)")
    assert _last(_same(both, "SELECT s, sum(v) OVER (ORDER BY s ROWS "
                             "UNBOUNDED PRECEDING) AS r FROM pk2 "
                             "ORDER BY s, v")) == [10, 30, 60, 100]


def test_window_desc_order(both):
    _mk(both[0], n=25)
    _mk(both[1], n=25)
    got = _last(_same(both, "SELECT k, t, row_number() OVER (PARTITION BY k "
                            "ORDER BY t DESC) AS rn FROM w "
                            "ORDER BY k, t DESC"))
    seen: dict = {}
    want = []
    for kk, _tt in both[1].execute("SELECT k, t FROM w ORDER BY k, t "
                                   "DESC").rows():
        seen[kk] = seen.get(kk, 0) + 1
        want.append(seen[kk])
    assert got == want


def test_window_string_partition(both):
    _run(both, "CREATE TABLE ws(name VARCHAR(10), v INT)",
         "INSERT INTO ws VALUES ('b', 1), ('a', 2), ('b', 3), ('a', 4), "
         "('c', 5)")
    assert _same(both, "SELECT name, sum(v) OVER (PARTITION BY name) AS s "
                       "FROM ws ORDER BY name, v") == [
        ("a", 6), ("a", 6), ("b", 4), ("b", 4), ("c", 5)]


def test_window_string_min_max(both):
    _run(both, "CREATE TABLE wm(k INT, name VARCHAR(10))",
         "INSERT INTO wm VALUES (1,'pear'), (1,'apple'), (1,'fig'), "
         "(2,'kiwi'), (2,'banana')")
    assert _same(both, "SELECT k, min(name) OVER (PARTITION BY k) AS lo, "
                       "max(name) OVER (PARTITION BY k) AS hi FROM wm "
                       "ORDER BY k, name") == [
        (1, "apple", "pear"), (1, "apple", "pear"), (1, "apple", "pear"),
        (2, "banana", "kiwi"), (2, "banana", "kiwi")]


def test_window_in_expression(both):
    _run(both, "CREATE TABLE wx(t INT, v INT)",
         "INSERT INTO wx VALUES (1, 10), (2, 20), (3, 40)")
    assert _last(_same(both, "SELECT t, v - lag(v, 1, 0) OVER (ORDER BY t) "
                             "AS d FROM wx ORDER BY t")) == [10, 10, 20]


def test_window_null_partition_groups_together(both):
    _run(both, "CREATE TABLE wn(k INT, v INT)",
         "INSERT INTO wn VALUES (1, 10), (NULL, 5), (1, 20), (NULL, 7), "
         "(NULL, 8)")
    rows = _same(both, "SELECT k, count(*) OVER (PARTITION BY k) AS c "
                       "FROM wn ORDER BY v")
    by_k: dict = {}
    for kk, c in rows:
        by_k.setdefault(kk, set()).add(c)
    assert by_k == {None: {3}, 1: {2}}


def test_window_rejected_in_grouped_query(both):
    _run(both, "CREATE TABLE wg(k INT, v INT)",
         "INSERT INTO wg VALUES (1, 10), (1, 20), (2, 30)")
    with pytest.raises(EvalError, match="window|GROUP"):
        both[1].execute("SELECT k, sum(sum(v)) OVER (ORDER BY k) FROM wg "
                        "GROUP BY k")


# --- the shapes that raise, with the JAX package's messages -----------------

RAISES = {
    "grouped": "SELECT k, sum(sum(v)) OVER (ORDER BY k) FROM wg GROUP BY k",
    "distinct": "SELECT k, count(DISTINCT v) OVER (PARTITION BY k) FROM wg",
    "range_offset": "SELECT k, sum(v) OVER (ORDER BY v RANGE BETWEEN 1 "
                    "PRECEDING AND CURRENT ROW) FROM wg",
    "minmax_without_current": "SELECT k, max(v) OVER (ORDER BY v ROWS "
                              "BETWEEN 3 PRECEDING AND 1 PRECEDING) FROM wg",
    "start_unbounded_following": "SELECT k, sum(v) OVER (ORDER BY v ROWS "
                                 "BETWEEN UNBOUNDED FOLLOWING AND CURRENT "
                                 "ROW) FROM wg",
    "end_unbounded_preceding": "SELECT k, sum(v) OVER (ORDER BY v ROWS "
                               "BETWEEN CURRENT ROW AND UNBOUNDED PRECEDING) "
                               "FROM wg",
    "unknown_function": "SELECT k, foo(v) OVER (ORDER BY v) FROM wg",
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_window_shapes_raise_as_jax(both, case):
    _run(both, "CREATE TABLE wg(k INT, v INT)",
         "INSERT INTO wg VALUES (1, 10), (1, 20), (2, 30)")
    msgs = []
    for db in both:
        with pytest.raises(Exception) as info:
            db.execute(RAISES[case])
        assert type(info.value).__name__ == "EvalError"
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_window_of_a_scalar_raises():
    """A constant key or argument, which the JAX package does not run
    either, raises EvalError."""
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.execute("CREATE TABLE wg(k INT, v INT)")
    ts.execute("INSERT INTO wg VALUES (1, 10), (1, 20), (2, 30)")
    for sql in ("SELECT k, sum(1) OVER (PARTITION BY k) FROM wg",
                "SELECT k, row_number() OVER (PARTITION BY 1) FROM wg"):
        with pytest.raises(EvalError, match="vary by row"):
            ts.execute(sql)


# --- windows in each tier's query shapes -------------------------------------

SHAPES = {
    # the fused scan's shape (one table, ungrouped)
    "scan": "SELECT t, v, sum(v) OVER (PARTITION BY k) AS s FROM w "
            "WHERE v > 10 ORDER BY t",
    # SELECT DISTINCT, which the plain-expression rewrite would make a
    # GROUP BY
    "distinct": "SELECT DISTINCT k, count(*) OVER (PARTITION BY k) AS c "
                "FROM w",
    # ASSUMING (the ordered tier's shape)
    "assuming": "SELECT k, t, row_number() OVER (PARTITION BY k ORDER BY t) "
                "AS r, sums(v) AS s FROM w ASSUMING ASC t",
    # a join (the star and count joins' shapes)
    "join": "SELECT w.t, d.name, rank() OVER (PARTITION BY d.name ORDER BY "
            "w.v DESC) AS r FROM w JOIN d ON w.k = d.k ORDER BY w.t",
    "comma_join": "SELECT w.t, count(*) OVER (PARTITION BY d.name) AS c "
                  "FROM w, d WHERE w.k = d.k ORDER BY w.t",
    # a derived table: db-benchmark's SQL of h2o q8
    "derived": "SELECT k, v FROM (SELECT k, v, row_number() OVER (PARTITION "
               "BY k ORDER BY v DESC) AS o FROM w WHERE v IS NOT NULL) sq "
               "WHERE o <= 2 ORDER BY k, v",
    "window_of_expression": "SELECT t, avg(v * 2 + k) OVER (PARTITION BY "
                            "k % 2 ORDER BY t ROWS BETWEEN 1 PRECEDING AND "
                            "1 FOLLOWING) AS a, v - lag(v) OVER (ORDER BY "
                            "t) AS d FROM w ORDER BY t",
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_window_in_tier_shapes_matches_jax(both, shape):
    """Every fused tier declines a projection with a window, and the
    general pipeline evaluates it."""
    for db in both:
        _mk(db, n=50, with_nulls=True)
        db.execute("CREATE TABLE d(k INT, name VARCHAR(10))")
        db.execute("INSERT INTO d VALUES (0, 'z0'), (1, 'z1'), (2, 'z2'), "
                   "(3, 'z3'), (4, 'z4')")
    assert _same(both, SHAPES[shape])


def test_derived_top2_matches_numpy(both):
    """db-benchmark's q8 form: per k, the two largest non-NULL v."""
    k, t, v, nulls = _mk(both[0], n=80, with_nulls=True)
    _mk(both[1], n=80, with_nulls=True)
    got = _same(both, SHAPES["derived"])
    want = []
    for kk in np.unique(k):
        vals = sorted((int(x) for x, nl in zip(v[k == kk], nulls[k == kk])
                       if not nl), reverse=True)[:2]
        want += [(int(kk), x) for x in sorted(vals)]
    assert got == want


# --- NULL order keys: the port's ORDER BY rule, held to numpy ----------------

def _null_table(db, n=70, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 4, n)
    v = rng.integers(-5, 6, n)          # ties, negatives and zeros
    null = rng.random(n) < 0.3
    db.execute("CREATE TABLE nk(id INT, k INT, v INT)")
    db.execute("INSERT INTO nk VALUES " + ", ".join(
        f"({i}, {k[i]}, {'NULL' if null[i] else v[i]})" for i in range(n)))
    return k, v, null


def _null_order_oracle(k, v, null, asc):
    """Per row: row_number, rank, and the default frame's sum of id, with
    NULL v first ascending and last descending, NULLs one peer group,
    ties in id order."""
    n = len(k)
    rn, rk, s = [0] * n, [0] * n, [0] * n
    for part in np.unique(k):
        ids = [i for i in range(n) if k[i] == part]

        def key(i):
            if null[i]:
                return (0,) if asc else (1,)
            return (1, v[i]) if asc else (0, -v[i])
        ids.sort(key=key)
        keys = [key(i) for i in ids]
        for j, i in enumerate(ids):
            rn[i] = j + 1
            rk[i] = keys.index(keys[j]) + 1
            last = max(m for m in range(len(ids)) if keys[m] == keys[j])
            s[i] = sum(ids[:last + 1])
    return rn, rk, s


@pytest.mark.parametrize("asc", [True, False], ids=["asc", "desc"])
def test_null_order_keys_match_numpy(asc):
    ts = aquery2_tpu_torch.connect(device="cpu")
    k, v, null = _null_table(ts)
    d = "" if asc else " DESC"
    over = f"OVER (PARTITION BY k ORDER BY v{d})"
    rows = ts.execute(f"SELECT id, row_number() {over} AS rn, rank() {over} "
                      f"AS rk, sum(id) {over} AS s FROM nk ORDER BY id").rows()
    rn, rk, s = _null_order_oracle(k, v, null, asc)
    assert rows == list(zip(range(len(k)), rn, rk, s))


@pytest.mark.parametrize("asc", [True, False], ids=["asc", "desc"])
def test_null_order_keys_agree_with_order_by(asc):
    """One query's ORDER BY and OVER (ORDER BY) put NULLs in one place."""
    ts = aquery2_tpu_torch.connect(device="cpu")
    _null_table(ts)
    d = "" if asc else " DESC"
    rows = ts.execute(f"SELECT v, row_number() OVER (ORDER BY v{d}) AS rn "
                      f"FROM nk ORDER BY v{d}").rows()
    rn = [r[1] for r in rows]
    vals = [r[0] for r in rows]
    nulls_first = vals[0] is None
    assert nulls_first == asc and None in vals
    # within the NULLs and each run of equal values the numbers ascend
    # in any order the sorts agree on; across them they follow ORDER BY
    groups = [tuple(sorted(rn[i] for i in range(len(vals))
                           if vals[i] == x)) for x in dict.fromkeys(vals)]
    flat = [r for g in groups for r in g]
    assert flat == list(range(1, len(vals) + 1))


# --- ops/window against aquery2_tpu.ops.window -------------------------------

N = 257


def _flags(seed):
    rng = np.random.default_rng(seed)
    f = rng.random(N) < 0.08
    f[0] = True
    return f


def _pair(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _eq(t: torch.Tensor, j, tol: float = 0.0):
    t, j = t.numpy(), np.asarray(j)
    if tol:
        np.testing.assert_allclose(t, j, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flag_helpers_match_jax(seed):
    jf, tf = _pair(_flags(seed))
    _eq(TW.positions(tf), JW.positions(jf))
    _eq(TW.is_last_from_flags(tf), JW.is_last_from_flags(jf))
    _eq(TW.first_index(tf), JW.first_index(jf))
    _eq(TW.last_index(tf), JW.last_index(jf))


def _bounds(tf: torch.Tensor):
    """Each row's partition's first and last row (int64), as
    EvalContext._window passes them to frame_bounds."""
    return (torch.arange(N) - TW.positions(tf),
            TW.last_index(tf).to(torch.int64))


BOUNDS = [(None, None), (None, 0), (-3, 0), (-2, 2), (0, 4), (-1, None),
          (2, 5), (-6, -2)]


@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_frame_bounds_match_jax(lo, hi):
    jf, tf = _pair(_flags(4))
    start, last = _bounds(tf)
    for t, j in zip(TW.frame_bounds(start, last, lo, hi),
                    JW.frame_bounds(jf, lo, hi)):
        _eq(t, j)
    # explicit indices (RANGE's peer bounds)
    pf = _flags(5) | _flags(4)
    jp, tp = _pair(pf)
    for t, j in zip(TW.frame_bounds(start, last, None, 0, None,
                                    TW.last_index(tp)),
                    JW.frame_bounds(jf, None, 0, None, JW.last_index(jp))):
        _eq(t, j)


@pytest.mark.parametrize("lo,hi", BOUNDS)
@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_frame_sums_match_jax(lo, hi, dtype):
    rng = np.random.default_rng(6)
    jf, tf = _pair(_flags(6))
    ind = rng.random(N) < 0.8
    x = np.where(ind, rng.integers(-50, 50, N), 0).astype(dtype)
    if dtype == np.float64:
        x = np.where(ind, rng.normal(size=N), 0.0)
    jx, tx = _pair(x)
    ji, ti = _pair(ind)
    tlo, thi, _ = TW.frame_bounds(*_bounds(tf), lo, hi)
    jlo, jhi, _ = JW.frame_bounds(jf, lo, hi)
    tol = FLOAT_TOL if dtype == np.float64 else 0.0
    for t, j in zip(TW.frame_sum_count(tx, ti, tf, tlo, thi),
                    JW.frame_sum_count(jx, ji, jf, jlo, jhi)):
        _eq(t, j, tol)
    for t, j in zip(TW.frame_moments(tx, ti, tf, tlo, thi),
                    JW.frame_moments(jx, ji, jf, jlo, jhi)):
        _eq(t, j, FLOAT_TOL)


EXTREME_BOUNDS = [(None, 0), (None, 3), (None, None), (-2, None), (0, None),
                  (-3, 0), (-2, 2), (0, 4), (-5, 1)]


@pytest.mark.parametrize("lo,hi", EXTREME_BOUNDS)
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64])
def test_frame_extreme_matches_jax(lo, hi, op, dtype):
    rng = np.random.default_rng(8)
    flags = _flags(8)
    jf, tf = _pair(flags)
    x = rng.integers(-1000, 1000, N).astype(dtype)
    jx, tx = _pair(x)
    tlo, thi, _ = TW.frame_bounds(*_bounds(tf), lo, hi)
    jlo, jhi, _ = JW.frame_bounds(jf, lo, hi)
    tpos, jpos = TW.positions(tf), JW.positions(jf)
    top = torch.minimum if op == "min" else torch.maximum
    jop = jnp.minimum if op == "min" else jnp.maximum
    got = TW.frame_extreme(tx, tf, tpos, lo, hi, top, tlo, thi)
    want = JW.frame_extreme(jx, jf, jpos, lo, hi, jop, jlo, jhi)
    _eq(got, want)
    # and the brute force, per row over its clamped frame
    starts = np.maximum.accumulate(np.where(flags, np.arange(N), 0))
    ends = np.r_[np.where(flags)[0][1:], N] - 1
    ends = ends[np.cumsum(flags) - 1]
    red = np.min if op == "min" else np.max
    for i in range(N):
        a = starts[i] if lo is None else max(starts[i], i + lo)
        b = ends[i] if hi is None else min(ends[i], i + hi)
        assert got[i].item() == red(x[a:b + 1]), i


def test_frame_extreme_rejects_frames_without_current_row():
    tf = torch.from_numpy(_flags(1))
    x = torch.zeros(N, dtype=torch.int32)
    lo_i, hi_i, _ = TW.frame_bounds(*_bounds(tf), 1, 3)
    with pytest.raises(ValueError, match="current row"):
        TW.frame_extreme(x, tf, TW.positions(tf), 1, 3, torch.minimum,
                         lo_i, hi_i)


def test_stddev_window_matches_numpy():
    """A float column's stddev over a sliding frame, against numpy's
    population standard deviation."""
    ts = aquery2_tpu_torch.connect(device="cpu")
    rng = np.random.default_rng(9)
    x = np.round(rng.normal(size=40) * 10, 3)
    ts.execute("CREATE TABLE f(i INT, x DOUBLE)")
    ts.execute("INSERT INTO f VALUES " + ", ".join(
        f"({i}, {float(x[i])!r})" for i in range(40)))
    got = _last(ts.execute("SELECT i, stddev(x) OVER (ORDER BY i ROWS "
                           "BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS s FROM f "
                           "ORDER BY i").rows())
    want = [float(np.std(x[max(0, i - 3):i + 2])) for i in range(40)]
    assert all(math.isclose(g, w, rel_tol=0, abs_tol=FLOAT_TOL)
               for g, w in zip(got, want))
