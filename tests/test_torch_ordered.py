"""The ordered path through both packages: h2o q8, subvec, every running
and windowed aggregate, ASSUMING ASC/DESC, and the trades queries, each
on identical tables in the JAX package and the port (connect("cpu")),
compared on names, SQL types, row order and values; and the pieces under
it: ops/segment.py, ops/scan.py's routing, seg_scan_multi's 64-bit lanes
and datagen.trades.

Integer results (sums, windowed sums, positions, min/max) are compared
exactly. Float results through float64 running sums take FLOAT_SUM_RTOL:
the port's kernels add in another order than XLA's doubling (on the CPU
both run the same doubling and agree, but the bound is what the port
promises). ``next`` is held to numpy: the JAX package reads the first
invalid row for the last row of the last group."""

import numpy as np
import pytest
import torch

import aquery2_tpu
from aquery2_tpu import types as JT
from aquery2_tpu.ops import scan as JS
from aquery2_tpu.ops import segment as JG
from aquery2_tpu.storage.table import Column as JColumn, Table as JTable
from aquery2_tpu.utils.datagen import trades_table
import jax.numpy as jnp

import aquery2_tpu_torch
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops import scan as S
from aquery2_tpu_torch.ops import segment as G
from aquery2_tpu_torch.storage.table import Table as TTable, VectorColumn
from aquery2_tpu_torch.utils.datagen import h2o_g1, trades
from bench import QUERIES

FLOAT_SUM_RTOL = 1e-12
N = 3000


def _sessions(cols: dict[str, np.ndarray], name: str = "t"):
    ref = JTable(name, [JColumn(nm, JT.from_np_dtype(a.dtype), a)
                        for nm, a in cols.items()])
    js = aquery2_tpu.connect()
    js.catalog.create(ref)
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.catalog.create(TTable.from_reference(ref, device="cpu"))
    return js, ts


def _compare(jr, tr, rtol=0.0):
    """Names, SQL types and every cell; float cells to rtol."""
    assert tr.column_names() == jr.column_names()
    assert tr.nrows == jr.nrows > 0
    for jc, tc in zip(jr.table.columns.values(), tr.table.columns.values()):
        assert tc.sqltype.name == jc.sqltype.name, tc.name
        assert tc.is_vector == jc.is_vector, tc.name
        jv, tv = jc.to_python(), tc.to_python()
        if tc.is_vector:
            assert [len(x) for x in tv] == [len(x) for x in jv], tc.name
            jv = [x for row in jv for x in row]
            tv = [x for row in tv for x in row]
        if rtol and tc.sqltype.np_dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(tv, float),
                                       np.asarray(jv, float), rtol=rtol,
                                       err_msg=tc.name)
        else:
            np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv),
                                          err_msg=tc.name)


@pytest.fixture(scope="module")
def ordered():
    rng = np.random.default_rng(31)
    return _sessions({
        "g": rng.integers(0, 40, N).astype(np.int32),
        "h": rng.integers(0, 3, N).astype(np.int32),
        "t": rng.permutation(N).astype(np.int32),
        "x": rng.integers(-50, 50, N).astype(np.int32),
        "f": np.round(rng.normal(size=N) * 10, 3).astype(np.float32),
    })


_RUNNING = ["sums", "avgs", "mins", "maxs", "vars", "stddevs", "ratios",
            "deltas", "prev"]          # next and aggnext: against numpy
_WINDOWED = ["sums", "avgs", "mins", "maxs", "vars", "stddevs", "ratios",
             "sumw", "avgw", "minw", "maxw", "varw", "stddevw", "ratiow"]


@pytest.mark.parametrize("arg", ["x", "f"])
@pytest.mark.parametrize("fn", _RUNNING)
def test_running_matches_jax(fn, arg, ordered):
    js, ts = ordered
    arg = "x + 51" if fn in ("ratios",) and arg == "x" else arg
    sql = (f"SELECT g, {fn}({arg}) AS r FROM t ASSUMING ASC t GROUP BY g")
    _compare(js.execute(sql), ts.execute(sql), FLOAT_SUM_RTOL)


@pytest.mark.parametrize("arg", ["x", "f"])
@pytest.mark.parametrize("fn", _WINDOWED)
def test_windowed_matches_jax(fn, arg, ordered):
    js, ts = ordered
    arg = "x + 51" if fn in ("ratios", "ratiow") and arg == "x" else arg
    sql = (f"SELECT g, h, {fn}(4, {arg}) AS r FROM t ASSUMING DESC t "
           f"GROUP BY g, h")
    _compare(js.execute(sql), ts.execute(sql), FLOAT_SUM_RTOL)


@pytest.mark.parametrize("sql", [
    "SELECT g, MAX(stddevs(3, x)) AS m, min(avgs(2, f)) AS a, sum(x) AS s "
    "FROM t ASSUMING ASC t GROUP BY g",
    "SELECT g, count(*) AS c, sum(deltas(x)) AS d, avg(f) AS a FROM t "
    "ASSUMING DESC f WHERE x > -20 GROUP BY g",
    "SELECT h, g, sums(x) * 2 AS s, maxs(f) - mins(f) AS r FROM t "
    "ASSUMING ASC t GROUP BY h, g",
])
def test_ordered_aggregates_match_jax(sql, ordered):
    js, ts = ordered
    _compare(js.execute(sql), ts.execute(sql), FLOAT_SUM_RTOL)


@pytest.mark.parametrize("fn", ["next", "aggnext"])
@pytest.mark.parametrize("arg", ["x", "f"])
def test_next_keeps_each_groups_last_value(arg, fn, ordered):
    """next(x): the following row's value in the group, the row's own at
    the group's last row (numpy oracle; see the module docstring)."""
    js, ts = ordered
    r = ts.execute(f"SELECT g, {fn}({arg}) AS n FROM t ASSUMING ASC t "
                   f"GROUP BY g")
    t = js.catalog.get("t")
    g, tt, x = (np.asarray(t[c].data)[:N] for c in ("g", "t", arg))
    order = np.lexsort((tt, g))
    want = []
    for k in np.unique(g):
        v = x[order][g[order] == k]
        want.append(np.r_[v[1:], v[-1:]].tolist())
    assert r.table.columns["g"].to_python() == np.unique(g).tolist()
    assert r.table.columns["n"].to_python() == want


def test_q8_matches_jax():
    data = h2o_g1(20_000, 10, 8)
    js, ts = _sessions(data, "source")
    _compare(js.execute(QUERIES["q8"]), ts.execute(QUERIES["q8"]))
    res = ts.execute(QUERIES["q8"]).table.columns
    v = res["largest2_v3"]
    assert isinstance(v, VectorColumn) and v.sqltype == T.VectorT(T.FloatT)
    ids, cnt = np.unique(data["id6"], return_counts=True)
    np.testing.assert_array_equal(res["id6"].to_numpy(), ids)
    np.testing.assert_array_equal(v.offsets_numpy(),
                                  np.r_[0, np.cumsum(np.minimum(cnt, 2))])
    back = TTable.from_reference(js.execute(QUERIES["q8"]).table, "cpu")
    assert back["largest2_v3"].to_python() == v.to_python()
    order = np.lexsort((-data["v3"], data["id6"]))
    first = np.r_[0, np.cumsum(cnt)[:-1]]
    pos = np.arange(len(order)) - np.repeat(first, cnt)
    np.testing.assert_array_equal(v.to_numpy(), data["v3"][order][pos < 2])


@pytest.mark.parametrize("assume", ["", "ASSUMING DESC v", "ASSUMING ASC v"])
def test_subvec_matches_jax(assume):
    """tests/test_e2e.py's subvec shape, with and without ASSUMING."""
    script = ("CREATE TABLE s(id INT, v INT);"
              "INSERT INTO s VALUES (1, 9), (1, 7), (1, 8), (2, 3), (2, 4),"
              "(3, 5), (1, 7)")
    js, ts = aquery2_tpu.connect(), aquery2_tpu_torch.connect(device="cpu")
    js.execute(script)
    ts.execute(script)
    for sql in (f"SELECT id, subvec(v, 0, 2) AS v FROM s {assume} GROUP BY id",
                f"SELECT id, subvec(v, 1, 3) AS v, count(*) AS c FROM s "
                f"{assume} GROUP BY id"):
        jr, tr = js.execute(sql), ts.execute(sql)
        assert tr.rows() == jr.rows()
        assert tr.format() == jr.format()
    assert ts.execute("SELECT id, subvec(v, 0, 2) AS v FROM s GROUP BY id"
                      ).rows() == [(1, [9, 7]), (2, [3, 4]), (3, [5])]


def test_desc_float_zeros_and_ties_match_jax():
    """ASSUMING DESC over floats with -0.0, 0.0, negatives and duplicates;
    ties keep insertion order wherever a carried column differs."""
    f = np.array([0.0, -0.0, -1.5, 2.0, -0.0, 2.0, -1.5, 0.0, 3.25, -7.0],
                 np.float32)
    g = np.array([1, 1, 1, 1, 2, 2, 2, 2, 1, 2], np.int32)
    seq = np.arange(10, dtype=np.int32) * 10
    js, ts = _sessions({"g": g, "f": f, "seq": seq})
    for sql in ("SELECT g, subvec(f, 0, 9) AS f, subvec(seq, 0, 9) AS s "
                "FROM t ASSUMING DESC f GROUP BY g",
                "SELECT g, sums(seq) AS s, prev(seq) AS p FROM t "
                "ASSUMING DESC f GROUP BY g",
                "SELECT g, subvec(seq, 0, 9) AS s FROM t ASSUMING ASC f "
                "GROUP BY g"):
        jr, tr = js.execute(sql), ts.execute(sql)
        assert tr.rows() == jr.rows()


def test_trades_match_jax():
    """datagen.trades equals the JAX package's trades_table; avgs(5, price)
    and MAX(stddevs(3, price)) under ASSUMING ASC time (tests/
    test_trades.py q7, q10)."""
    js = aquery2_tpu.connect()
    trades_table("trades", 20_000, n_symbols=50, seed=7, session=js)
    arrays, d = trades(20_000, 50, 7)
    jt = js.catalog.get("trades")
    for nm, arr in arrays.items():
        np.testing.assert_array_equal(np.asarray(jt[nm].data)[:20_000], arr)
    assert d.strings() == jt["stocksymbol"].dictionary.strings()
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.catalog.create(TTable.from_numpy(
        "trades", arrays, {"stocksymbol": T.StrT}, device="cpu",
        dictionaries={"stocksymbol": d}))
    for sql in ("SELECT stocksymbol, avgs(5, price) AS a FROM trades "
                "ASSUMING ASC time GROUP BY stocksymbol",
                "SELECT stocksymbol, MAX(stddevs(3, price)) AS m FROM trades "
                "ASSUMING ASC time GROUP BY stocksymbol"):
        jr, tr = js.execute(sql), ts.execute(sql)
        _compare(jr, tr, FLOAT_SUM_RTOL)
        assert tr.format(limit=3) == jr.format(limit=3)


def test_ordered_unported_shapes_raise():
    """Ordered queries over a nullable column and ungrouped running
    aggregates (which the port once declined) answer as the JAX package's
    general engine does: ASSUMING puts the NULL first, and a running sum
    reads it as 0."""
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    for db in (js, ts):
        db.execute("CREATE TABLE n(g INT, v INT);"
                   "INSERT INTO n VALUES (1, NULL), (1, 3), (2, 4)")
    for sql in ("SELECT g, sums(v) AS s FROM n ASSUMING ASC v GROUP BY g",
                "SELECT sums(v) AS s FROM n"):
        jr, tr = js.execute(sql), ts.execute(sql)
        _compare(jr, tr)
        assert tr.rows() == jr.rows()


# --- the pieces under the ordered path ---------------------------------------

def test_segment_helpers_match_jax(rng):
    n = 5000
    flags = rng.random(n) < 0.03
    flags[0] = True
    ids = np.cumsum(flags).astype(np.int32)
    tf = torch.from_numpy(flags)
    np.testing.assert_array_equal(G.pos_from_flags(tf).numpy(),
                                  np.asarray(JG.pos_from_flags(
                                      jnp.asarray(flags))))
    np.testing.assert_array_equal(
        G.flags_from_segment_ids(torch.from_numpy(ids)).numpy(),
        np.asarray(JG.flags_from_segment_ids(jnp.asarray(ids))))
    np.testing.assert_array_equal(G.last_flags(tf).numpy(),
                                  np.asarray(JG.last_flags(jnp.asarray(flags))))
    assert G.pos_from_flags(tf).dtype == torch.int32


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_seg_scan_multi_64bit_lanes(op, dtype, rng):
    """64-bit lanes of seg_scan_multi's plain version against a row loop
    and against the JAX package's seg_scan (XLA's doubling): int64 adds
    wrap, float64 min/max propagate NaN."""
    n = 4000
    flags = rng.random(n) < 0.02
    if dtype == np.int64:
        x = rng.integers(2**62 - 2**20, 2**62, n)
        x[rng.random(n) < 0.4] *= -1
    else:
        x = rng.normal(size=n) * 1e6
        x[::61] = np.nan
    got = K.seg_scan_multi(torch.from_numpy(flags), (torch.from_numpy(x),),
                           (op,))[0].numpy()
    comb = {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[op]
    want = np.asarray(JS.seg_scan(jnp.asarray(x), jnp.asarray(flags), comb))
    np.testing.assert_array_equal(got, want)
    acc = None
    loop = np.empty_like(x)
    with np.errstate(over="ignore", invalid="ignore"):
        for i in range(n):
            acc = x[i] if acc is None or flags[i] else {
                "add": np.add, "min": np.minimum, "max": np.maximum}[op](
                    acc, x[i])
            loop[i] = acc
    if op == "add" and dtype == np.float64:
        np.testing.assert_allclose(got, loop, rtol=1e-9, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, loop)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.int16,
                                   torch.int32, torch.int64, torch.float32,
                                   torch.float64])
def test_scan_extremes_keep_dtype(dtype, rng):
    """seg_cummin/seg_cummax of every dtype come back in it (narrow ints
    and bools through int32 lanes)."""
    n = 1000
    flags = torch.from_numpy(rng.random(n) < 0.05)
    x = torch.from_numpy(rng.integers(-100, 100, n)).to(dtype)
    for fn, np_fn in ((S.seg_cummin, np.minimum), (S.seg_cummax, np.maximum)):
        got = fn(x, flags)
        assert got.dtype == dtype
        want = x.numpy().copy()
        for i in range(1, n):
            if not flags[i]:
                want[i] = np_fn(want[i - 1], want[i])
        np.testing.assert_array_equal(got.numpy(), want)


def test_result_types_match_jax():
    for name in [*S.RUNNING, *S.WINDOWED]:
        for jt, tt in ((JT.IntT, T.IntT), (JT.FloatT, T.FloatT),
                       (JT.LongT, T.LongT), (JT.DoubleT, T.DoubleT)):
            assert S.result_type(name, tt).name == \
                JS.result_type(name, jt).name, name
