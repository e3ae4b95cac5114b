"""User FUNCTIONs through both packages: every case of
tests/test_udf_rewrite.py but the mesh one (ROADMAP item 9), through the
port (aquery2_tpu_torch.connect("cpu")) against the JAX package
(aquery2_tpu.connect()) on the same seeded rows, then scalar FUNCTION
inlining and the host interpreter, and the AGGREGATION FUNCTION calls the
rewrite declines, which run their bodies on the device
(engine/udf_device.py) and equal the JAX package's.

The rewritten udfcov sums integer lanes exactly, so it matches the JAX
package's interpreted loop to REL (float64 formula); a scalar FUNCTION's
float sums to REL as well (another order of summation)."""

import numpy as np
import pytest

import aquery2_tpu
from aquery2_tpu.engine import udf_device as jax_udf_device
from aquery2_tpu.engine import udf_rewrite as jax_udf_rewrite

import aquery2_tpu_torch
from aquery2_tpu_torch.engine import fused_groupby, udf, udf_rewrite
from aquery2_tpu_torch.parser import ast_nodes as A
from aquery2_tpu_torch.parser import parse

REL = 1e-12
UDFCOV = """AGGREGATION FUNCTION udfcov(x, y){
    sx := 0.; sy := 0.; sxy := 0.;
    l := _builtin_len;
    for (i := 0; i < l; i += 1) { sx += x[i]; sy += y[i]; sxy += x[i]*y[i]; }
    (sxy - sx * sy / l) / l
}"""
SCALAR = "FUNCTION f(p, q) { v := p * q; w := v / 100; w - p }"
RUNSUM = """AGGREGATION FUNCTION runsum(x){
    s := 0.;
    l := _builtin_len;
    for (i := 0; i < l; i += 1) { s += x[i]; _builtin_ret[i] := s; }
    Null
}"""
FIRSTHALF = """AGGREGATION FUNCTION firsthalf(x){
    s := 0.;
    h := _builtin_len / 2;
    for (i := 0; i < h; i += 1) { s += x[i]; }
    s
}"""


def _rows(n=4000, seed=7):
    rng = np.random.default_rng(seed)
    return [(int(k), int(k2), int(x), int(y)) for k, k2, x, y in zip(
        rng.integers(1, 40, n), rng.integers(1, 5, n),
        rng.integers(0, 30, n), rng.integers(0, 30, n))]


def _load(s, rows):
    s.execute(UDFCOV)
    s.execute("CREATE TABLE t(k INT, k2 INT, a INT, b INT)")
    s.catalog.get("t").append_rows(rows)
    return s


@pytest.fixture
def ts():
    return _load(aquery2_tpu_torch.connect(device="cpu"), _rows())


@pytest.fixture
def js():
    return _load(aquery2_tpu.connect(), _rows())


def _np(ts, col):
    return ts.catalog.get("t").columns[col].to_numpy()


def _approx_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a == pytest.approx(b, rel=REL, abs=1e-15)


# --- the cases of tests/test_udf_rewrite.py ----------------------------------

def test_rewrite_call_shape(ts):
    """udfcov(a, b) rewrites to (sum(a*b) - sum(a)*sum(b)/count(*))/count(*),
    as the JAX package rewrites it."""
    call = A.Call("udfcov", (A.ColumnRef("a"), A.ColumnRef("b")))
    out = udf_rewrite.rewrite_call(ts.udfs["udfcov"], call, ts.udfs)
    cnt = A.Call("count", (A.Star(),))
    a, b = A.ColumnRef("a"), A.ColumnRef("b")
    assert out == A.BinOp(
        "/",
        A.BinOp("-", A.Call("sum", (A.BinOp("*", a, b),)),
                A.BinOp("/", A.BinOp("*", A.Call("sum", (a,)),
                                     A.Call("sum", (b,))), cnt)),
        cnt)
    js = aquery2_tpu.connect()
    js.execute(UDFCOV)
    from aquery2_tpu.parser import ast_nodes as JA
    jcall = JA.Call("udfcov", (JA.ColumnRef("a"), JA.ColumnRef("b")))
    assert repr(jax_udf_rewrite.rewrite_call(js.udfs["udfcov"], jcall,
                                             js.udfs)) == repr(out)


def test_rewrite_select_fires_and_matches_interpreter(ts, js, monkeypatch):
    """The rewritten query against the JAX package's host interpreter of
    the loop (its oracle in tests/test_udf_rewrite.py)."""
    q = "SELECT k, udfcov(a, b) AS c FROM t GROUP BY k"
    rewritten = ts.execute(q).rows()
    monkeypatch.setattr(jax_udf_rewrite, "rewrite_select",
                        lambda session, sel: None)
    monkeypatch.setattr(jax_udf_device, "try_run_fused", lambda *a, **k: None)
    monkeypatch.setattr(jax_udf_device, "try_run_aggregation_udf",
                        lambda *a, **k: None)
    oracle = js.execute(q).rows()
    assert len(rewritten) == len(oracle)
    got = dict(rewritten)
    for k, v in oracle:
        assert got[k] == pytest.approx(v, rel=REL, abs=1e-15), k


def test_rewritten_query_takes_fused_tier(ts, monkeypatch):
    """The rewritten query runs the fused group-by, and no FUNCTION code
    is reached."""
    hits = []
    orig = fused_groupby.run

    def spy(sel, table):
        out = orig(sel, table)
        hits.append(out is not None)
        return out

    monkeypatch.setattr(fused_groupby, "run", spy)
    monkeypatch.setattr(udf, "run_aggregation_udf",
                        lambda *a, **k: pytest.fail("FUNCTION code reached"))
    ts.execute("SELECT k, udfcov(a, b) AS c FROM t GROUP BY k")
    assert hits and hits[-1]


def test_ungrouped_udf_rewrites(ts, js):
    r = ts.execute("SELECT udfcov(a, b) AS c FROM t").rows()
    a = _np(ts, "a").astype(np.float64)
    b = _np(ts, "b").astype(np.float64)
    assert r[0][0] == pytest.approx(float((a * b).mean() - a.mean()
                                          * b.mean()), rel=REL)
    _approx_rows(r, js.execute("SELECT udfcov(a, b) AS c FROM t").rows())


def test_reducer_prologue_rewrites(ts, js):
    """Bodies made of reducer calls (no loop) rewrite too."""
    q = "SELECT k2, spread(a) AS s FROM t GROUP BY k2 ORDER BY k2"
    for db in (ts, js):
        db.execute("AGGREGATION FUNCTION spread(x){ max(x) - min(x) }")
    r = ts.execute(q).rows()
    assert r == js.execute(q).rows()
    k2, a = _np(ts, "k2"), _np(ts, "a")
    assert r == [(int(kk), int(a[k2 == kk].max() - a[k2 == kk].min()))
                 for kk in np.unique(k2)]


def test_minus_accumulation_and_literal_param(ts, js):
    body = """AGGREGATION FUNCTION negsum(x, c){
        s := 0.;
        for (i := 0; i < _builtin_len; i += 1) { s -= x[i] * c; }
        s
    }"""
    q = "SELECT k2, negsum(a, 2) AS s FROM t GROUP BY k2 ORDER BY k2"
    for db in (ts, js):
        db.execute(body)
    r = ts.execute(q).rows()
    _approx_rows(r, js.execute(q).rows())
    k2, a = _np(ts, "k2"), _np(ts, "a").astype(np.int64)
    for kk, s in r:
        assert s == pytest.approx(-2.0 * a[k2 == kk].sum())


def test_vector_returning_udf_does_not_rewrite(ts, js):
    for db in (ts, js):
        db.execute(RUNSUM)
    call = A.Call("runsum", (A.ColumnRef("a"),))
    assert udf_rewrite.rewrite_call(ts.udfs["runsum"], call, ts.udfs) is None
    q = "SELECT runsum(a), k2 FROM t GROUP BY k2"
    got = ts.execute(q).rows()
    assert ts.stats.udf_paths == {"traced": 1}
    want = js.execute(q).rows()
    assert [r[1] for r in got] == [r[1] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=REL)


def test_partial_range_loop_does_not_rewrite(ts, js):
    """A loop over part of the group keeps the loop's semantics."""
    for db in (ts, js):
        db.execute(FIRSTHALF)
    call = A.Call("firsthalf", (A.ColumnRef("a"),))
    assert udf_rewrite.rewrite_call(ts.udfs["firsthalf"], call,
                                    ts.udfs) is None
    q = "SELECT k2, firsthalf(a) FROM t GROUP BY k2"
    got = ts.execute(q).rows()
    assert ts.stats.udf_paths == {"traced": 1}
    _approx_rows(got, js.execute(q).rows())
    k2, a = _np(ts, "k2"), _np(ts, "a").astype(np.float64)
    for kk, v in got:
        x = a[k2 == kk]
        assert v == pytest.approx(x[:int(np.ceil(len(x) / 2))].sum(),
                                  rel=REL)


def test_nullable_args_do_not_rewrite(ts, js):
    """SQL aggregates skip NULLs and the loop visits every row: a nullable
    argument column keeps the loop's semantics (a NULL row reads its
    stored 0, as in the JAX package)."""
    for db in (ts, js):
        db.execute("CREATE TABLE tn(k INT, a INT, b INT)")
        db.execute("INSERT INTO tn VALUES (1, 1, 2), (1, NULL, 3), "
                   "(2, 4, 5)")
    sel = parse("SELECT k, udfcov(a, b) FROM tn GROUP BY k")[0]
    assert udf_rewrite.rewrite_select(ts, sel) is None
    q = "SELECT k, udfcov(a, b) FROM tn GROUP BY k"
    got = ts.execute(q).rows()
    assert ts.stats.udf_paths == {"traced": 1}
    _approx_rows(got, js.execute(q).rows())
    assert got == [(1, pytest.approx((2 - 1 * 5 / 2) / 2)), (2, 0.0)]


# --- registering, scalar FUNCTIONs, the host interpreter --------------------

def test_functions_register_case_insensitively(ts):
    ts.execute(SCALAR)
    assert ts.udfs["UDFCOV"].is_aggregation
    assert not ts.udfs["F"].is_aggregation
    assert ts.udfs["f"].params == ["p", "q"]


def test_scalar_function_inlines_on_the_device_path(ts, js, monkeypatch):
    """f's two bindings run as tensor ops inside sum(): no host
    interpreter, the same sums as the JAX package's inlining."""
    for db in (ts, js):
        db.execute(SCALAR)
        db.execute("FUNCTION g(x, y) { s := x; s += y; s *= 2; s - x }")
    monkeypatch.setattr(udf._HostEval, "run",
                        lambda *a: pytest.fail("host interpreter reached"))
    for q in ("SELECT k2, sum(f(a, b)) AS s FROM t GROUP BY k2 ORDER BY k2",
              "SELECT k, g(a, b) AS v FROM t WHERE k < 3 ORDER BY k, v",
              "SELECT max(f(a, b) + g(b, a)) AS m FROM t"):
        got = ts.execute(q)
        want = js.execute(q)
        assert got.column_names() == want.column_names()
        _approx_rows(got.rows(), want.rows())
    k2 = _np(ts, "k2")
    a, b = _np(ts, "a").astype(np.int64), _np(ts, "b").astype(np.int64)
    got = dict(ts.execute("SELECT k2, sum(f(a, b)) FROM t GROUP BY k2")
               .rows())
    for kk in np.unique(k2):
        m = k2 == kk
        assert got[int(kk)] == pytest.approx(
            float((a[m] * b[m] / 100 - a[m]).sum()), rel=REL)


def test_scalar_function_host_path(ts, monkeypatch):
    """All-scalar arguments and if/else bodies take the host interpreter,
    as in the JAX package; held to Python's own arithmetic."""
    ts.execute(SCALAR)
    ts.execute("FUNCTION sgn2(x) { if (x > 1) { x * 2 } else { x - 1 } }")
    ts.execute("FUNCTION loop3(x) { s := 0; for (i := 0; i < 3; i += 1) "
               "{ s += x; } s }")
    runs = []
    orig = udf._from_host

    def spy(ctx, res):
        runs.append(res)
        return orig(ctx, res)

    monkeypatch.setattr(udf, "_from_host", spy)
    r = ts.execute("SELECT f(2, 5) AS a, sgn2(3) AS b, sgn2(1) AS c, "
                   "loop3(4) AS d")
    assert r.rows() == [(2 * 5 / 100 - 2, 6, 0, 12)]
    assert len(runs) == 4


def test_aggregation_function_over_a_join(ts, js):
    """The rewrite reads only single-table FROMs, as the JAX package's
    does; over a join the body runs in the general pipeline."""
    for db in (ts, js):
        db.execute("CREATE TABLE d(k INT, w INT)")
        db.execute("INSERT INTO d VALUES (1, 10), (2, 20)")
    q = ("SELECT t.k2, udfcov(t.a, d.w) FROM t JOIN d ON t.k = d.k "
         "GROUP BY t.k2 ORDER BY t.k2")
    got = ts.execute(q).rows()
    assert ts.stats.udf_paths == {"traced": 1}
    _approx_rows(got, js.execute(q).rows())
    k, k2 = _np(ts, "k"), _np(ts, "k2")
    a = _np(ts, "a").astype(np.float64)
    m = k <= 2
    w = np.where(k == 1, 10.0, 20.0)
    for kk, v in got:
        g = m & (k2 == kk)
        x, y = a[g], w[g]
        assert v == pytest.approx((x * y).mean() - x.mean() * y.mean(),
                                  rel=1e-9, abs=1e-12)
