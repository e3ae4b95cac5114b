"""AGGREGATION FUNCTION bodies on the device, through both packages.

Every case of tests/test_udf_device.py and of the JAX package's tests of
its fused UDF tier, through the port (aquery2_tpu_torch.connect("cpu"))
against the JAX package (aquery2_tpu.connect()) on the same seeded rows,
with those files' tolerances (the port runs the fused tier's queries
through the general pipeline's traced route); then each construct of the batched body on its own
(an if nested in a for, elif chains, augmented writes to indexed locals,
subvec, every reducer and elementwise function, a whole-table call, a
call over a join), skewed groups across length classes, the rows of a
group in insertion order under every grouping of the general pipeline
(held to numpy), a body the device path declines (the host interpreter,
as in the JAX package) and NULL arguments (their stored values, as in
the JAX package). The route of each call is read from
``session.stats.udf_paths``; a route is forced as the JAX files force it,
by monkeypatching ``udf_device.try_run_aggregation_udf`` or
``udf_rewrite.rewrite_select``."""

import numpy as np
import pytest

import aquery2_tpu
from aquery2_tpu.engine import udf_rewrite as jax_udf_rewrite

import aquery2_tpu_torch
from aquery2_tpu_torch.engine import udf_device, udf_rewrite

COVARIANCES2 = """
AGGREGATION FUNCTION covariances2(x, y, win){
    xmeans := 0.;
    ymeans := 0.;
    l := _builtin_len;
    if (l > 0)
    {
        xmeans := x[0];
        ymeans := y[0];
        _builtin_ret[0] := 0.;
    }
    w := win;
    if (w > l)
        w := l;
    for (i := 1, j:= 0; i < w; i := i+1) {
        xmeans += x[i];
        ymeans += y[i];
        _builtin_ret[i] := avg (( x(0, i) - xmeans/i ) * (y(0, i) - ymeans/i ));
    }
    xmeans /= w;
    ymeans /= w;
    for (i := w; i < l; i += 1)
    {
        xmeans += (x[i] - x[i - w]) / w;
        ymeans += (y[i] - y[i - w]) / w;
        _builtin_ret[i] := avg (( x(i-w, i) - xmeans ) * (y(i - w, i) - ymeans ));
    }
    Null
}
"""
UDFCOV = """AGGREGATION FUNCTION udfcov(x, y){
    sx := 0.; sy := 0.; sxy := 0.;
    l := _builtin_len;
    for (i := 0; i < l; i += 1) { sx += x[i]; sy += y[i]; sxy += x[i]*y[i]; }
    (sxy - sx * sy / l) / l
}"""
MYSUMSQ = """AGGREGATION FUNCTION mysumsq(x){
    s := 0.;
    l := _builtin_len;
    for (i := 0; i < l; i += 1) { s += x[i] * x[i]; }
    s
}"""
RUNSUM = """AGGREGATION FUNCTION runsum(x){
    s := 0.;
    l := _builtin_len;
    for (i := 0; i < l; i += 1) { s += x[i]; _builtin_ret[i] := s; }
    Null
}"""
CLIPSUM = """AGGREGATION FUNCTION clipsum(x, c){ s := 0.; l := _builtin_len;
    for (i := 0; i < l; i += 1) { if (x[i] > c) { s += c; }
    else { s += x[i]; } } s }"""
BUCKETS = """AGGREGATION FUNCTION buckets(x){ s := 0.;
    for (i := 0; i < _builtin_len; i += 1) {
        if (x[i] < 10) { s += 1; } elif (x[i] < 20) { s += 10; }
        elif (x[i] < 30) { s += 100; } else { s += 1000; } }
    s }"""
INDEXED = """AGGREGATION FUNCTION indexed(x){
    for (i := 0; i < _builtin_len; i += 1) {
        _builtin_ret[i] := x[i]; _builtin_ret[i] += 1; _builtin_ret[i] *= 3;
        _builtin_ret[i] -= x[0]; _builtin_ret[i] /= 4; }
    Null }"""
FIRSTLAST = """AGGREGATION FUNCTION firstlast(x){ l := _builtin_len;
    x[0] * 1000000 + x[l - 1] }"""
NULLBODY = """AGGREGATION FUNCTION nullbody(x){ s := 0.; l := _builtin_len;
    for (i := 0; i < l; i += 1) { s += x[i]; }
    if (l > 100000) { s := s + Null; } s }"""
TWICE = """AGGREGATION FUNCTION twice(x){ s := 0.;
    for (i := 0; i < _builtin_len; i += 1) { s += 2 * x[i]; if (s > 1e9)
    { s := 0; } } s }"""
REL = 1e-12


def _rows(n=400, seed=12345):
    rng = np.random.default_rng(seed)
    return list(zip(rng.integers(0, 50, n).astype(int).tolist(),
                    rng.integers(0, 50, n).astype(int).tolist(),
                    rng.integers(0, 7, n).astype(int).tolist()))


def _udfcov_rows(n=4000, seed=12345):
    rng = np.random.default_rng(seed)
    return [(int(k), int(k2), int(x), int(y)) for k, k2, x, y in zip(
        rng.integers(1, 40, n), rng.integers(1, 5, n),
        rng.integers(0, 30, n), rng.integers(0, 30, n))]


def _abc(s, rows):
    s.execute(COVARIANCES2)
    s.execute("CREATE TABLE t(a INT, b INT, c INT)")
    s.catalog.get("t").append_rows(rows)
    return s


@pytest.fixture
def ts():
    return _abc(aquery2_tpu_torch.connect(device="cpu"), _rows())


@pytest.fixture
def js():
    return _abc(aquery2_tpu.connect(), _rows())


def _host_only(monkeypatch):
    monkeypatch.setattr(udf_device, "try_run_aggregation_udf",
                        lambda *a, **k: None)


def _close(got, want, rtol=1e-9, atol=1e-12):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, (list, tuple)) or isinstance(a, float):
                np.testing.assert_allclose(np.asarray(a, np.float64),
                                           np.asarray(b, np.float64),
                                           rtol=rtol, atol=atol)
            else:
                assert a == b


# --- the cases of tests/test_udf_device.py ---------------------------------

def test_covariances2_device_matches_host(ts, js, monkeypatch):
    q = "SELECT covariances2(a, b, 4), c FROM t GROUP BY c"
    dev = ts.execute(q).rows()
    assert ts.stats.udf_paths == {"traced": 1}
    _close(dev, js.execute(q).rows())
    _host_only(monkeypatch)
    host = ts.execute(q).rows()
    assert ts.stats.udf_paths == {"traced": 1, "interpreted": 1}
    _close(dev, host)


def test_device_path_is_used(ts):
    calls = []
    orig = udf_device.try_run_aggregation_udf

    def spy(ctx, udf, args):
        out = orig(ctx, udf, args)
        calls.append(out is not None)
        return out

    udf_device.try_run_aggregation_udf = spy
    try:
        ts.execute("SELECT covariances2(a, b, 4), c FROM t GROUP BY c")
    finally:
        udf_device.try_run_aggregation_udf = orig
    assert calls and all(calls)
    assert "interpreted" not in ts.stats.udf_paths


def test_scalar_returning_aggregation_udf(ts, js, monkeypatch):
    for db in (ts, js):
        db.execute(MYSUMSQ)
    q = "SELECT c, mysumsq(a) FROM t GROUP BY c ORDER BY c"
    dev = ts.execute(q).rows()
    _close(dev, js.execute(q).rows(), rtol=REL, atol=0)
    _host_only(monkeypatch)
    _close(dev, ts.execute(q).rows(), rtol=REL, atol=0)
    tbl = ts.catalog.get("t")
    av = tbl.columns["a"].to_numpy().astype(np.float64)
    cv = tbl.columns["c"].to_numpy()
    want = {k: float((av[cv == k] ** 2).sum()) for k in np.unique(cv)}
    for dc, dv in dev:
        assert dv == pytest.approx(want[dc], rel=REL)


def test_whole_table_aggregation_udf(ts, js, monkeypatch):
    q = "SELECT covariances2(a, b, 3) FROM t"
    dev = ts.execute(q).rows()
    assert ts.stats.udf_paths == {"traced": 1}
    _close(dev, js.execute(q).rows())
    _host_only(monkeypatch)
    _close(dev, ts.execute(q).rows())


# --- the cases of the JAX package's fused UDF tier tests --------------------

FUSED_QUERIES = [
    "SELECT k, udfcov(a, b) FROM t GROUP BY k",
    "SELECT k, udfcov(a, b) AS c FROM t GROUP BY k",
    "SELECT k, k2, udfcov(a, b) AS c FROM t GROUP BY k, k2",
    "SELECT k, udfcov(a, b) AS c FROM t WHERE a > 3 GROUP BY k",
]


def _kk(s):
    s.execute(UDFCOV)
    s.execute("CREATE TABLE t(k INT, k2 INT, a INT, b INT)")
    s.catalog.get("t").append_rows(_udfcov_rows())
    return s


@pytest.fixture
def tk(monkeypatch):
    """udfcov rewrites into plain aggregates and would never reach the
    batched body under test: the rewrite is off here, in both packages,
    as in the JAX package's fused UDF tier tests."""
    monkeypatch.setattr(udf_rewrite, "rewrite_select",
                        lambda session, sel: None)
    monkeypatch.setattr(jax_udf_rewrite, "rewrite_select",
                        lambda session, sel: None)
    return _kk(aquery2_tpu_torch.connect(device="cpu"))


@pytest.fixture
def jk(tk):
    return _kk(aquery2_tpu.connect())


@pytest.mark.parametrize("q", FUSED_QUERIES)
def test_grouped_udf_matches_jax_fused_tier(tk, jk, q):
    """The port's traced route gives the rows and the column names of the
    JAX package's fused UDF tier."""
    res = tk.execute(q)
    assert tk.stats.udf_paths == {"traced": 1}
    ref = jk.execute(q)
    assert jk.stats.udf_paths == {"fused": 1}
    assert res.column_names() == ref.column_names()
    got, want = sorted(res.rows()), sorted(ref.rows())
    assert len(got) == len(want)
    for fr, gr in zip(got, want):
        assert fr[:-1] == gr[:-1]
        assert fr[-1] == pytest.approx(gr[-1], rel=1e-12, abs=1e-15)


def test_fused_udf_oracle(tk):
    r = tk.execute("SELECT k, udfcov(a, b) AS c FROM t GROUP BY k")
    assert tk.stats.udf_paths == {"traced": 1}
    tbl = tk.catalog.get("t")
    k = tbl.columns["k"].to_numpy()
    a = tbl.columns["a"].to_numpy().astype(np.float64)
    b = tbl.columns["b"].to_numpy().astype(np.float64)
    got = dict(r.rows())
    for kk in np.unique(k):
        m = k == kk
        want = float((a[m] * b[m]).mean() - a[m].mean() * b[m].mean())
        assert got[int(kk)] == pytest.approx(want, rel=1e-9)


def test_vector_returning_udf_stays_general(tk, jk):
    """Ragged-output UDFs (covariances2-style) keep the general path."""
    for db in (tk, jk):
        db.execute(RUNSUM)
    q = "SELECT runsum(a), k2 FROM t GROUP BY k2"
    r = tk.execute(q)
    assert tk.stats.udf_paths == {"traced": 1}
    assert r.nrows == 4
    vals = r.rows()[0][0]
    assert len(vals) > 1 and vals[1] >= vals[0]
    _close(r.rows(), jk.execute(q).rows(), rtol=REL, atol=0)


# --- each construct on its own ----------------------------------------------

def _pair(rows, *bodies):
    out = []
    for s in (aquery2_tpu_torch.connect(device="cpu"), aquery2_tpu.connect()):
        _abc(s, rows)
        for b in bodies:
            s.execute(b)
        out.append(s)
    return out


def _np_abc(rows):
    a, b, c = (np.asarray(x) for x in zip(*rows))
    return a.astype(np.float64), b.astype(np.float64), c


CONSTRUCTS = {
    # an if nested in a for (grouped, then grouped and ordered)
    "if_in_for": (CLIPSUM, "SELECT c, clipsum(a, 20) FROM t GROUP BY c",
                  lambda a, b: np.minimum(a, 20).sum()),
    "if_in_for_general": (CLIPSUM, "SELECT c, clipsum(a, 20) FROM t GROUP BY "
                          "c ORDER BY c",
                          lambda a, b: np.minimum(a, 20).sum()),
    "elif_chain": (BUCKETS, "SELECT c, buckets(a) FROM t GROUP BY c",
                   lambda a, b: float(np.select([a < 10, a < 20, a < 30],
                                                [1, 10, 100], 1000).sum())),
    "nested_assign": (TWICE, "SELECT c, twice(b) FROM t GROUP BY c",
                      lambda a, b: 2 * b.sum()),
    "and_or": ("AGGREGATION FUNCTION lg(x){ sum((x > 10) and (x < 40)) + "
               "sum(x or 0) + count(x(1, 3)) + ((x[0] > 5) or (x[1] < 5)) }",
               "SELECT c, lg(a) FROM t GROUP BY c",
               lambda a, b: (((a > 10) & (a < 40)).sum() + (a != 0).sum()
                             + len(a[1:3]) + float(a[0] > 5 or a[1] < 5))),
    "subvec": ("AGGREGATION FUNCTION sv(x){ sum(subvec(x, 1, 3)) + "
               "count(x(2, 5)) }",
               "SELECT c, sv(a) FROM t GROUP BY c",
               lambda a, b: a[1:3].sum() + len(a[2:5])),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
def test_construct_matches_jax_and_numpy(name):
    body, q, fn = CONSTRUCTS[name]
    rows = _rows()
    t, j = _pair(rows, body)
    got = t.execute(q).rows()
    assert not {"interpreted", "rewritten"} & set(t.stats.udf_paths)
    _close(got, j.execute(q).rows(), rtol=REL, atol=0)
    a, b, c = _np_abc(rows)
    want = {int(k): fn(a[c == k], b[c == k]) for k in np.unique(c)}
    assert {k: v for k, v in got} == pytest.approx(want, rel=REL)


def test_indexed_augmented_writes():
    rows = _rows()
    t, j = _pair(rows, INDEXED)
    q = "SELECT c, indexed(a) FROM t GROUP BY c"
    got = t.execute(q).rows()
    assert t.stats.udf_paths == {"traced": 1}
    _close(got, j.execute(q).rows(), rtol=REL, atol=0)
    a, _b, c = _np_abc(rows)
    for k, v in got:
        x = a[c == k]
        np.testing.assert_allclose(v, ((x + 1) * 3 - x[0]) / 4, rtol=REL)


REDUCERS = ("sum", "avg", "mean", "count", "min", "max", "first", "last")


@pytest.mark.parametrize("red", REDUCERS)
def test_reducers_over_slices(red):
    """Each reducer over a slice inside every group (groups of 40-80
    rows), as a scalar body and per element of _builtin_ret."""
    body = (f"AGGREGATION FUNCTION r1(x){{ {red}(x(1, _builtin_len - 2)) + "
            f"{red}(x) }}")
    body2 = (f"AGGREGATION FUNCTION r2(x){{ for (i := 3; i < _builtin_len; "
             f"i += 1) {{ _builtin_ret[i] := {red}(x(i - 3, i)); }} Null }}")
    rows = _rows()
    t, j = _pair(rows, body, body2)
    for q in ("SELECT c, r1(b) FROM t GROUP BY c",
              "SELECT c, r2(b) FROM t GROUP BY c"):
        got = t.execute(q).rows()
        _close(got, j.execute(q).rows(), rtol=REL, atol=0)
    assert t.stats.udf_paths == {"traced": 2}
    _a, b, c = _np_abc(rows)
    fn = {"sum": np.sum, "avg": np.mean, "mean": np.mean, "count": len,
          "min": np.min, "max": np.max, "first": lambda v: v[0],
          "last": lambda v: v[-1]}[red]
    got = dict(t.execute("SELECT c, r1(b) FROM t GROUP BY c").rows())
    for k in np.unique(c):
        x = b[c == k]
        assert got[int(k)] == pytest.approx(fn(x[1:len(x) - 2]) + fn(x),
                                            rel=REL)


ELEMENTWISE = {"sqrt": np.sqrt, "abs": np.abs, "exp": np.exp, "log": np.log,
               "floor": np.floor, "ceil": np.ceil, "round": np.round,
               "sign": np.sign}


@pytest.mark.parametrize("fn", sorted(ELEMENTWISE) + ["pow"])
def test_elementwise_functions(fn):
    """Each function on per-group scalars (x[i]), on a vector and on a
    per-call constant (the loop skips row 0, so the rewrite declines).
    The divisor is 8: XLA divides by a constant through its reciprocal,
    which for 7 moves x / 7 - 2.5 off the halves that round() splits
    (ROADMAP queue 3), and 1/8 is exact."""
    if fn == "pow":
        call, vcall, const = "pow(x[i] / 8 - 2, 2)", "pow(x, 0.5)", \
            "pow(3, 0.5)"
    else:
        call, vcall, const = f"{fn}(x[i] / 8 - 2.5)", f"{fn}(x - 20)", \
            f"{fn}(0.75)"
    if fn in ("sqrt", "log"):
        call, vcall = f"{fn}(x[i] / 8 + 0.5)", f"{fn}(x + 1)"
    body = (f"AGGREGATION FUNCTION ew(x){{ s := 0.; for (i := 1; "
            f"i < _builtin_len; i += 1) {{ s += {call}; }} "
            f"s + sum({vcall}) + {const} }}")
    rows = _rows()
    t, j = _pair(rows, body)
    q = "SELECT c, ew(a) FROM t GROUP BY c"
    got = t.execute(q).rows()
    assert t.stats.udf_paths == {"traced": 1}
    _close(got, j.execute(q).rows(), rtol=REL, atol=1e-12)
    a, _b, c = _np_abc(rows)
    f = ELEMENTWISE.get(fn)
    for k, v in got:
        x = a[c == k]
        y = x[1:]
        if fn == "pow":
            want = ((y / 8 - 2) ** 2).sum() + np.sqrt(x).sum() + 3 ** 0.5
        elif fn in ("sqrt", "log"):
            want = f(y / 8 + 0.5).sum() + f(x + 1).sum() + f(0.75)
        else:
            want = f(y / 8 - 2.5).sum() + f(x - 20).sum() + f(0.75)
        assert v == pytest.approx(want, rel=REL, abs=1e-12)


def test_whole_table_scalar_call():
    rows = _rows()
    t, j = _pair(rows, CLIPSUM)
    q = "SELECT clipsum(a, 25) AS s FROM t"
    got = t.execute(q).rows()
    assert t.stats.udf_paths == {"traced": 1}
    _close(got, j.execute(q).rows(), rtol=REL, atol=0)
    a, _b, _c = _np_abc(rows)
    assert got == [(pytest.approx(np.minimum(a, 25).sum(), rel=REL),)]


def test_call_over_a_join():
    rows = _rows()
    t, j = _pair(rows, CLIPSUM)
    for s in (t, j):
        s.execute("CREATE TABLE d(c INT, w INT)")
        s.execute("INSERT INTO d VALUES (0, 3), (1, 5), (2, 7), (3, 11), "
                  "(4, 13), (5, 17)")
    q = ("SELECT d.w, clipsum(t.a, 20) AS s FROM t JOIN d ON t.c = d.c "
         "GROUP BY d.w ORDER BY d.w")
    got = t.execute(q).rows()
    assert t.stats.udf_paths == {"traced": 1}
    _close(got, j.execute(q).rows(), rtol=REL, atol=0)
    a, _b, c = _np_abc(rows)
    w = {0: 3, 1: 5, 2: 7, 3: 11, 4: 13, 5: 17}
    assert got == [(w[k], pytest.approx(np.minimum(a[c == k], 20).sum(),
                                        rel=REL)) for k in range(6)]


# --- length classes, row order ------------------------------------------------

def _skewed(seed=5):
    """One group of 5,000 rows among 600 groups of 1-3 rows, interleaved."""
    rng = np.random.default_rng(seed)
    small = np.repeat(np.arange(1, 601), rng.integers(1, 4, 600))
    keys = np.concatenate([small, np.zeros(5000, np.int64)])
    keys = keys[rng.permutation(len(keys))]
    vals = rng.integers(0, 100, len(keys))
    return keys, vals


def test_skewed_groups_across_length_classes():
    keys, vals = _skewed()
    rows = [(int(v), int(v) % 7, int(k)) for k, v in zip(keys, vals)]
    t, j = _pair(rows, CLIPSUM, RUNSUM)
    for q in ("SELECT c, clipsum(a, 50) AS s FROM t GROUP BY c",
              "SELECT c, clipsum(a, 50) AS s FROM t GROUP BY c ORDER BY c",
              "SELECT c, runsum(a) AS r FROM t GROUP BY c"):
        got = t.execute(q).rows()
        _close(got, j.execute(q).rows(), rtol=REL, atol=0)
    assert t.stats.udf_paths == {"traced": 3}
    got = dict(t.execute("SELECT c, runsum(a) FROM t GROUP BY c").rows())
    for k in (0, 1, 300, 600):
        np.testing.assert_allclose(got[k], np.cumsum(vals[keys == k]),
                                   rtol=REL)
    got = dict(t.execute("SELECT c, clipsum(a, 50) FROM t GROUP BY c").rows())
    for k in np.unique(keys):
        assert got[int(k)] == pytest.approx(
            np.minimum(vals[keys == k], 50).sum(), rel=REL)


def _first_last(keys, vals):
    out = {}
    for k in np.unique(keys):
        x = vals[keys == k]
        out[k] = x[0] * 1000000.0 + x[-1]
    return out


ORDER_GROUPINGS = {
    # each grouping of the general pipeline
    "plain": "SELECT k, firstlast(v) AS f FROM s GROUP BY k",
    "dense": "SELECT k, firstlast(v) AS f FROM s GROUP BY k ORDER BY k",
    "sort": "SELECT fk, firstlast(v) AS f FROM s GROUP BY fk",
    "nullable": "SELECT nk, firstlast(v) AS f FROM s GROUP BY nk",
    "join": ("SELECT d.w, firstlast(s.v) AS f FROM s JOIN d ON s.k = d.k "
             "GROUP BY d.w"),
}


@pytest.mark.parametrize("route", sorted(ORDER_GROUPINGS))
def test_rows_of_a_group_in_insertion_order(route):
    """x[0] and x[l - 1] read a group's first and last rows in the
    table's order, under every route that groups the rows."""
    rng = np.random.default_rng(11)
    n = 3000
    k = rng.integers(0, 40, n)
    v = rng.integers(0, 1000, n)
    nk_null = rng.random(n) < 0.1
    db = aquery2_tpu_torch.connect(device="cpu")
    db.execute(FIRSTLAST)
    db.execute("CREATE TABLE s(k INT, fk DOUBLE, nk INT, v INT)")
    db.catalog.get("s").append_rows(
        [(int(a), float(a) + 0.5, None if z else int(a) % 9, int(b))
         for a, b, z in zip(k, v, nk_null)])
    db.execute("CREATE TABLE d(k INT, w INT)")
    db.execute("INSERT INTO d VALUES " + ", ".join(
        f"({i}, {1000 + i})" for i in range(40)))
    got = dict(db.execute(ORDER_GROUPINGS[route]).rows())
    assert db.stats.udf_paths == {"traced": 1}
    if route == "nullable":
        keys = np.where(nk_null, -1, k % 9)
        want = {(None if a == -1 else int(a)): b
                for a, b in _first_last(keys, v).items()}
    elif route == "sort":
        want = {float(a) + 0.5: b for a, b in _first_last(k, v).items()}
    elif route == "join":
        want = {1000 + int(a): b for a, b in _first_last(k, v).items()}
    else:
        want = {int(a): b for a, b in _first_last(k, v).items()}
    assert got == want


# --- the host interpreter, NULL arguments -------------------------------------

def test_untraceable_body_is_interpreted():
    """A NULL literal in an expression: the device path declines the
    body, and the host interpreter answers, as in the JAX package."""
    rows = _rows()
    t, j = _pair(rows, NULLBODY)
    for q in ("SELECT c, nullbody(a) AS s FROM t GROUP BY c",
              "SELECT nullbody(b) AS s FROM t"):
        got = t.execute(q).rows()
        _close(got, j.execute(q).rows(), rtol=REL, atol=0)
    assert t.stats.udf_paths == {"interpreted": 2}
    assert j.stats.udf_paths == {"interpreted": 2}
    a, _b, c = _np_abc(rows)
    got = dict(t.execute("SELECT c, nullbody(a) FROM t GROUP BY c").rows())
    assert got == {int(k): pytest.approx(a[c == k].sum(), rel=REL)
                   for k in np.unique(c)}


def test_null_arguments_read_stored_values():
    """NULL rows of an argument read their stored value (0), on the device
    as in both JAX paths; the rewrite declines a nullable argument."""
    vals = []
    for s in (aquery2_tpu_torch.connect(device="cpu"), aquery2_tpu.connect()):
        s.execute(UDFCOV)
        s.execute(RUNSUM)
        s.execute("CREATE TABLE n(k INT, a INT, b DOUBLE)")
        s.execute("INSERT INTO n VALUES (1, 1, 2.5), (1, NULL, 3.5), "
                  "(1, 4, NULL), (2, 4, 5.5), (2, NULL, NULL), (3, 7, 1.0)")
        out = [s.execute(q).rows() for q in (
            "SELECT k, udfcov(a, b) AS c FROM n GROUP BY k",
            "SELECT k, runsum(a) AS r FROM n GROUP BY k",
            "SELECT udfcov(a, b) AS c FROM n")]
        assert s.stats.udf_paths == {"traced": 3}
        vals.append(out)
    for got, want in zip(*vals):
        _close(got, want, rtol=REL, atol=1e-15)
    assert vals[0][1] == [(1, [1.0, 1.0, 5.0]), (2, [4.0, 4.0]), (3, [7.0])]
