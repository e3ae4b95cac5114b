"""The joins through both packages: h2o qj and qjg, the explicit JOIN
forms, the star join's other shapes and the count join's edges. The JAX
package (aquery2_tpu.connect()) and the port (aquery2_tpu_torch.connect(
"cpu")) get identical tables from one numpy seed and must return the same
values, SQL types and row order, compared exactly: counts and integer sums
are exact in both, and the float averages here are the fused group-by's
limb sums, equal bit for bit (tests/test_torch_slice.py).

Column names are compared too, except where the JAX package names a
column after its internal rewrite (``__star_w`` for ``d.w``, a fault in
ROADMAP queue 3): the port must name it as the SQL does (``w``). Where
the JAX package answers wrongly or fails (float join keys, ROADMAP queue
3), the port is held to numpy."""

import numpy as np
import pytest
import torch

import aquery2_tpu
from aquery2_tpu import types as JT
from aquery2_tpu.storage.table import Column as JColumn, Table as JTable
from aquery2_tpu.storage.table import StringDict as JStringDict

import aquery2_tpu_torch
from aquery2_tpu_torch.engine import executor as TE
from aquery2_tpu_torch.engine import fused_join, fused_star
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.storage.table import Column as TColumn
from aquery2_tpu_torch.storage.table import Table as TTable
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.utils.datagen import h2o_dim, h2o_g1, h2o_j1
from bench import QUERIES

N = 3 * 2 ** 14
SEED = 20240

H2O_CASES = {
    "qj": QUERIES["qj"],
    "qjg": QUERIES["qjg"],
    "natural": ("SELECT w, count(*) AS c, avg(v3) AS a FROM source "
                "NATURAL JOIN dim GROUP BY w"),
    "on": ("SELECT id3, count(*) AS c FROM source s JOIN dim d "
           "ON s.id3 = d.id3 GROUP BY id3"),
    "using": ("SELECT d.w, sum(s.v2) AS s2, max(s.v3) AS m FROM source s "
              "JOIN dim d USING (id3) GROUP BY d.w"),
    "dim_key": ("SELECT d.id3, count(*) FROM source s, dim d "
                "WHERE s.id3 = d.id3 GROUP BY d.id3"),
    "residual": ("SELECT d.w, count(*) AS c, sum(s.v1) AS sv FROM source s, "
                 "dim d WHERE s.id3 = d.id3 AND s.v2 > 7 AND s.v3 < 60.5 "
                 "GROUP BY d.w"),
    "having_order": ("SELECT d.w, count(*) AS c FROM source s, dim d "
                     "WHERE s.id3 = d.id3 GROUP BY d.w HAVING count(*) > 10 "
                     "ORDER BY c DESC, d.w"),
    "having_order_limit": ("SELECT d.w, sum(s.v1) FROM source s, dim d "
                           "WHERE s.id3 = d.id3 GROUP BY d.w "
                           "HAVING sum(s.v1) > 100 ORDER BY d.w DESC LIMIT 20"),
    "packed_tier": ("SELECT s.id1, d.w, count(*) AS c FROM source s, dim d "
                    "WHERE s.id3 = d.id3 GROUP BY s.id1, d.w"),
    "dim_first": ("SELECT d.w, count(*) AS c FROM dim d, source s "
                  "WHERE d.id3 = s.id3 GROUP BY d.w"),
    "qj_dim_first": "SELECT count(*) AS n FROM dim d, source s WHERE d.id3 = s.id3",
}


def _load(tables: dict[str, dict[str, np.ndarray]]):
    """Both packages' sessions over the same tables."""
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    for name, arrays in tables.items():
        ref = JTable(name, [JColumn(k, JT.from_np_dtype(v.dtype), v)
                            for k, v in arrays.items()])
        js.catalog.create(ref)
        ts.catalog.create(TTable.from_reference(ref, device="cpu"))
    return js, ts


def _assert_same(js, ts, sql):
    jr, tr = js.execute(sql), ts.execute(sql)
    assert tr.column_names() == [nm.removeprefix("__star_")
                                 for nm in jr.column_names()]
    assert tr.nrows == jr.nrows > 0
    for jc, tc in zip(jr.table.columns.values(), tr.table.columns.values()):
        assert tc.sqltype.name == jc.sqltype.name, tc.name
        jv = np.asarray(jc.data)[:jc.nrows]
        tv = tc.to_numpy()
        assert tv.dtype == jv.dtype, tc.name
        np.testing.assert_array_equal(tv, jv, err_msg=f"{sql}: {tc.name}")
    return tr


def _count(ts, sql) -> int:
    r = ts.execute(sql)
    assert r.column_names() == ["count"] and r.nrows == 1
    return r.scalar()


@pytest.fixture(scope="module")
def h2o():
    src, dim = h2o_g1(N, 10, SEED), h2o_dim(N, 10, SEED)
    return (src, dim), _load({"source": src, "dim": dim})


def test_h2o_dim_shape():
    dim = h2o_dim(N, 10, SEED)
    nk = N // 10
    assert list(dim) == ["id3", "w"] and len(dim["id3"]) == nk // 10
    assert dim["id3"].dtype == dim["w"].dtype == np.int32
    assert len(np.unique(dim["id3"])) == nk // 10            # unique keys
    assert dim["id3"].min() >= 1 and dim["id3"].max() <= nk  # in id3's domain
    assert dim["w"].min() >= 1 and dim["w"].max() <= 99
    np.testing.assert_array_equal(dim["w"], h2o_dim(N, 10, SEED)["w"])


@pytest.mark.parametrize("name", list(H2O_CASES))
def test_h2o_join_matches_jax(name, h2o):
    _data, (js, ts) = h2o
    _assert_same(js, ts, H2O_CASES[name])


def test_qj_qjg_match_numpy(h2o):
    (src, dim), (_js, ts) = h2o
    hit = np.isin(src["id3"], dim["id3"])
    assert _count(ts, QUERIES["qj"]) == int(hit.sum())
    w_of = dict(zip(dim["id3"].tolist(), dim["w"].tolist()))
    w = np.array([w_of[k] for k in src["id3"][hit]])
    r = ts.execute(QUERIES["qjg"])
    assert r.column_names() == ["w", "c", "sv"]
    ws = np.unique(w)
    np.testing.assert_array_equal(r.table.columns["w"].to_numpy(), ws)
    np.testing.assert_array_equal(r.table.columns["c"].to_numpy(),
                                  [(w == x).sum() for x in ws])
    v1 = src["v1"][hit].astype(np.int64)
    np.testing.assert_array_equal(r.table.columns["sv"].to_numpy(),
                                  [v1[w == x].sum() for x in ws])


def test_qjg_on_cpu_launches_nothing(h2o):
    _data, (_js, ts) = h2o
    before = dict(K.LAUNCHES)
    ts.execute(QUERIES["qjg"])
    assert K.LAUNCHES == before


# the fused-join tests of the JAX package (tests/test_fused.py), ported
@pytest.fixture(scope="module")
def fused_db():
    rng = np.random.default_rng(12345)
    n = 5000
    src = {"id1": rng.integers(1, 11, n).astype(np.int32),
           "id3": rng.integers(1, 501, n).astype(np.int32),
           "v1": rng.integers(1, 6, n).astype(np.int32),
           "v3": np.round(rng.random(n) * 100, 6).astype(np.float32)}
    keys = np.unique(src["id3"]).astype(np.int32)
    dims = {
        "dim": {"id3": keys[::3]},
        "dimw": {"id3": keys[::2], "w": np.random.default_rng(3).integers(
            1, 5, len(keys[::2])).astype(np.int32)},
        "dimn": {"id3": keys, "w": np.random.default_rng(7).integers(
            1, 4, len(keys)).astype(np.int32)},
    }
    return src, dims, _load({"source": src, **dims})


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM source s, dim d WHERE s.id3 = d.id3",
    "SELECT d.w, count(*) AS c, sum(s.v1) AS sv FROM source s, dimw d "
    "WHERE s.id3 = d.id3 GROUP BY d.w",
    "SELECT d.id3, count(*) AS c FROM source s, dimw d "
    "WHERE s.id3 = d.id3 AND s.v1 > 2 GROUP BY d.id3",
    "SELECT w, count(*) AS c FROM source NATURAL JOIN dimn GROUP BY w",
    "SELECT id3, count(*) AS c FROM source s JOIN dimn d ON s.id3 = d.id3 "
    "GROUP BY id3",
])
def test_fused_join_tests_match_jax(sql, fused_db):
    src, dims, (js, ts) = fused_db
    tr = _assert_same(js, ts, sql)
    if "dimw" in sql and "d.w" in sql:                  # the numpy oracle
        lut = dict(zip(dims["dimw"]["id3"].tolist(),
                       dims["dimw"]["w"].tolist()))
        want: dict[int, list[int]] = {}
        for k, v1 in zip(src["id3"].tolist(), src["v1"].tolist()):
            if k in lut:
                c = want.setdefault(lut[k], [0, 0])
                c[0] += 1
                c[1] += v1
        assert {r[0]: [r[1], r[2]] for r in tr.rows()} == want


def _count_join_tables(rng):
    return {"l": {"k": rng.integers(-50, 50, 4000).astype(np.int32)},
            "r": {"k": rng.integers(-60, 40, 700).astype(np.int32)},
            "r2": {"k": np.full(5, 999, np.int32)},
            "l2": {"k": np.full(3, 7, np.int32)},
            "r3": {"k": np.full(2, 7, np.int32)}}


@pytest.mark.parametrize("pair", [("l", "r"), ("r", "l"), ("l", "r2"),
                                  ("l2", "r3")])
def test_count_join_edges_match_jax(pair):
    """Negative keys, no overlap, and duplicate keys on both sides."""
    tables = _count_join_tables(np.random.default_rng(12345))
    js, ts = _load(tables)
    a, b = pair
    sql = f"SELECT count(*) FROM {a}, {b} WHERE {a}.k = {b}.k"
    _assert_same(js, ts, sql)
    la, lb = tables[a]["k"], tables[b]["k"]
    assert _count(ts, sql) == sum(int((la == k).sum()) for k in lb)
    if pair == ("l2", "r3"):
        assert _count(ts, sql) == 6


def test_count_join_empty_build_side():
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.execute("CREATE TABLE e(k INT); CREATE TABLE f(k INT);"
               "INSERT INTO f VALUES (0), (1), (0)")
    assert _count(ts, "SELECT count(*) FROM f, e WHERE f.k = e.k") == 0
    assert _count(ts, "SELECT count(*) FROM e, f WHERE e.k = f.k") == 0


def test_count_join_wide_int64_keys_match_jax():
    """int64 keys spanning 2^40: a domain past PERFECT_HASH_MAX_DOMAIN, so
    the sort route."""
    rng = np.random.default_rng(5)
    pool = rng.integers(-2**40, 2**40, 300)
    tables = {"l": {"k": rng.choice(pool, 5000)},
              "r": {"k": rng.choice(np.r_[pool[:150], pool[:40]], 400)}}
    js, ts = _load(tables)
    sql = "SELECT count(*) FROM l, r WHERE l.k = r.k"
    _assert_same(js, ts, sql)
    want = sum(int((tables["l"]["k"] == k).sum()) for k in tables["r"]["k"])
    assert want > 0 and _count(ts, sql) == want


@pytest.mark.parametrize("ltype,rtype", [("DOUBLE", "DOUBLE"),
                                         ("REAL", "DOUBLE"),
                                         ("DOUBLE", "INT"),
                                         ("INT", "DOUBLE")])
def test_count_join_float_keys_match_numpy(ltype, rtype):
    """Float keys take the sort route, compared in float64 where an int
    column meets a float one: 2.5 matches no integer, -0.0 matches 0, NaN
    matches nothing. (The JAX package's sort route fails on a float build
    key, and its histogram truncates a float probe key: ROADMAP queue 3.)"""
    lv = [1.0, 2.5, -0.0, 3.0, 3.0, float("nan"), 7.0, 2.0]
    rv = [3.0, 2.0, 0.0, float("nan"), 3.0, 9.0, 2.5, 1.0]
    ts = aquery2_tpu_torch.connect(device="cpu")
    for name, vals, typ in (("l", lv, ltype), ("r", rv, rtype)):
        if typ == "INT":
            vals = [v for v in vals if np.isfinite(v) and v == int(v)]
        dt = {"DOUBLE": np.float64, "REAL": np.float32, "INT": np.int32}[typ]
        ts.catalog.create(TTable.from_numpy(name, {"k": np.array(vals, dt)},
                                            device="cpu"))
    a = ts.catalog.get("l").columns["k"].to_numpy().astype(np.float64)
    b = ts.catalog.get("r").columns["k"].to_numpy().astype(np.float64)
    want = int((a[:, None] == b[None, :]).sum())
    assert _count(ts, "SELECT count(*) FROM l, r WHERE l.k = r.k") == want
    assert _count(ts, "SELECT count(*) FROM r, l WHERE r.k = l.k") == want


def test_count_join_routes_agree(h2o):
    """Both kept routes on qj's columns, called directly."""
    _data, (_js, ts) = h2o
    s, d = ts.catalog.get("source").columns["id3"], \
        ts.catalog.get("dim").columns["id3"]
    mn, mx = d.stats()
    hist = fused_join.count_histogram(s, d, mn, mx)
    assert hist.dtype == torch.int64 and hist.dim() == 0
    assert int(hist) == int(fused_join.count_sorted(s, d)) == \
        int(fused_join.count_sorted(d, s)) == _count(ts, QUERIES["qj"])


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.int32,
                                   np.int64, np.bool_])
def test_domain_codes_match_numpy(dtype, rng):
    """Keys below, in and above [mn, mx] (bounds past the dtype's range
    included) map to key - mn or to the spare slot mx - mn + 1; padding
    rows past n are not read."""
    if dtype == np.bool_:
        keys = rng.random(300) < 0.5
        bounds = [(0, 1), (1, 1), (0, 0), (-3, 5)]
    else:
        info = np.iinfo(dtype)
        keys = rng.integers(info.min, int(info.max) + 1, 300, dtype=dtype)
        keys[:4] = [info.min, info.max, 0, 1]
        bounds = [(-3, 5), (int(info.min) - 7, int(info.min) + 40),
                  (int(info.max) - 20, int(info.max) + 9), (300, 400),
                  (int(info.min) - 50, int(info.min) - 10)]
    t = torch.from_numpy(keys)
    for mn, mx in bounds:
        got = fused_star.domain_codes(t, 250, mn, mx)
        want = [x - mn if mn <= x <= mx else mx - mn + 1
                for x in keys[:250].tolist()]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str((mn, mx)))


def test_build_positions():
    keys = np.array([5, 9, 6, 12], np.int32)
    col = TColumn("k", T.IntT, keys, device="cpu")
    pos, unique = fused_star.build_positions(col, 5, 12)
    want = np.full(9, -1, np.int32)
    want[keys - 5] = np.arange(4)
    np.testing.assert_array_equal(pos.numpy(), want)
    assert bool(unique)
    dup = TColumn("k", T.IntT, np.array([5, 9, 5], np.int32), device="cpu")
    assert not bool(fused_star.build_positions(dup, 5, 9)[1])


def test_probe_of_unmatched_and_out_of_domain_rows():
    """Keys outside the domain, below or above it, and absent keys inside
    it match nothing; matched rows read their dim row."""
    dim = TColumn("k", T.IntT, np.array([10, 12, 13], np.int32), device="cpu")
    pos, _unique = fused_star.build_positions(dim, 10, 13)
    w = torch.tensor([100, 200, 300], dtype=torch.int32)
    pk = TColumn("k", T.IntT, np.array([9, 10, 11, 13, 14, -5, 12], np.int32),
                 device="cpu")
    match, (got,) = fused_star.probe(pos, pk, 10, [w])
    assert match.tolist() == [False, True, False, True, False, False, True]
    assert got[match].tolist() == [100, 300, 200]


def _load_any(tables):
    """Both packages over {name: {col: array, masked array or (codes,
    StringDict)}}."""
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    for name, arrays in tables.items():
        cols = []
        for k, v in arrays.items():
            if isinstance(v, tuple):
                codes, d = v
                cols.append(JColumn(k, JT.StrT, codes,
                                    dictionary=JStringDict(d.strings())))
                continue
            valid = None
            if isinstance(v, np.ma.MaskedArray):
                valid = ~np.ma.getmaskarray(v)
                v = v.filled(0)
            cols.append(JColumn(k, JT.from_np_dtype(v.dtype), v, valid=valid))
        ref = JTable(name, cols)
        js.catalog.create(ref, replace=True)
        ts.catalog.create(TTable.from_reference(ref, device="cpu"),
                          replace=True)
    return js, ts


def _same_rows(js, ts, sql, rtol=0.0, jsql=None):
    """Port (sql) == JAX (jsql or sql): names, SQL types and rows in
    order; floats to rtol, NULLs as None."""
    jr, tr = js.execute(jsql or sql), ts.execute(sql)
    assert tr.column_names() == [nm.split(".")[-1].removeprefix("__star_")
                                 for nm in jr.column_names()], sql
    assert [c.sqltype.name for c in tr.table.columns.values()] == \
        [c.sqltype.name for c in jr.table.columns.values()], sql
    trows, jrows = tr.rows(), jr.rows()
    assert len(trows) == len(jrows), sql
    if not rtol:
        assert trows == jrows, sql
        return tr
    for t, j in zip(trows, jrows):
        for a, b in zip(t, j):
            if isinstance(b, float) and a is not None:
                np.testing.assert_allclose(a, b, rtol=rtol, err_msg=sql)
            else:
                assert a == b, sql
    return tr


@pytest.mark.parametrize("case", ["duplicate_dim_keys", "nullable_source",
                                  "three_tables", "ungrouped_sum"])
def test_general_join_shapes_raise(case):
    """The shapes the JAX package sends to its general join, which raised
    before item 6b, equal the JAX package."""
    src = h2o_g1(2000, 10, SEED, nas=5 if case == "nullable_source" else 0)
    dim = h2o_dim(2000, 10, SEED)
    if case == "duplicate_dim_keys":
        dim = {k: np.r_[v, v[:3]] for k, v in dim.items()}
    js, ts = _load_any({"source": src, "dim": dim,
                        "dim2": h2o_dim(2000, 10, 1)})
    sql = {"three_tables": "SELECT d.w, count(*) AS c FROM source s, dim d, "
                           "dim2 e WHERE s.id3 = d.id3 AND d.id3 = e.id3 "
                           "GROUP BY d.w",
           "ungrouped_sum": "SELECT sum(s.v1) FROM source s, dim d "
                            "WHERE s.id3 = d.id3"}.get(case, QUERIES["qjg"])
    _same_rows(js, ts, sql)


J1_X = "x.id1, x.id2, x.id3, x.id4, x.id5, x.id6, x.v1"
J1 = {  # db-benchmark's join questions, as its SQL solutions write them
    "q1": "SELECT {x}, small.id4 AS small_id4, v2 FROM x JOIN small "
          "USING (id1)",
    "q2": "SELECT {x}, medium.id1 AS medium_id1, medium.id4 AS medium_id4, "
          "medium.id5 AS medium_id5, v2 FROM x JOIN medium USING (id2)",
    "q3": "SELECT {x}, medium.id1 AS medium_id1, medium.id4 AS medium_id4, "
          "medium.id5 AS medium_id5, v2 FROM x LEFT JOIN medium USING (id2)",
    "q4": "SELECT {x}, medium.id1 AS medium_id1, medium.id2 AS medium_id2, "
          "medium.id4 AS medium_id4, v2 FROM x JOIN medium USING (id5)",
    "q5": "SELECT {x}, big.id1 AS big_id1, big.id2 AS big_id2, "
          "big.id4 AS big_id4, big.id5 AS big_id5, big.id6 AS big_id6, v2 "
          "FROM x JOIN big USING (id3)",
}


@pytest.fixture(scope="module")
def j1():
    tables = h2o_j1(10_000, SEED)
    flat = {name: {c: (a, dicts[c]) if c in dicts else a
                   for c, a in arrays.items()}
            for name, (arrays, dicts) in tables.items()}
    return tables, _load_any(flat)


def test_h2o_j1_shape(j1):
    """join-datagen.R's shape: sizes, unique right keys where the R
    script draws each key once, and about 90% of x's keys matching."""
    tables, _ = j1
    x, small, medium, big = (tables[t][0] for t in ("x", "small", "medium",
                                                    "big"))
    assert [len(t["v1" if t is x else "v2"]) for t in (x, small, medium,
                                                       big)] == \
        [10_000, 10, 10, 10_000]
    assert list(x) == ["id1", "id2", "id3", "id4", "id5", "id6", "v1"]
    assert list(medium) == ["id1", "id2", "id4", "id5", "v2"]
    for t, k in ((small, "id1"), (medium, "id2"), (big, "id3"), (x, "id3")):
        assert len(np.unique(t[k])) == len(t[k])
    for t, k in ((small, "id1"), (medium, "id2"), (big, "id3")):
        assert 0.85 < np.isin(x[k], t[k]).mean() < 0.95
    assert tables["x"][1]["id5"] is not tables["medium"][1]["id5"]


@pytest.mark.parametrize("q", sorted(J1))
def test_j1_questions_match_jax(q, j1):
    """Each question as the benchmark runs it, a CREATE TABLE AS of the
    join, against the JAX package's SELECT. ``x.*`` is x's columns; the
    JAX package expands a qualified star to every source's (ROADMAP
    queue 3), so its query names them."""
    _tables, (js, ts) = j1
    ts.execute(f"CREATE TABLE ans AS {J1[q].format(x='x.*')}")
    jr = js.execute(J1[q].format(x=J1_X))
    tr = ts.execute("SELECT * FROM ans")
    assert tr.column_names() == [nm.split(".")[-1]
                                 for nm in jr.column_names()]
    assert [c.sqltype.name for c in tr.table.columns.values()] == \
        [c.sqltype.name for c in jr.table.columns.values()]
    assert tr.rows() == jr.rows()
    _same_rows(js, ts, f"SELECT count(*) AS c, sum(v1) AS s1, sum(v2) AS s2 "
                       f"FROM ({J1[q].format(x=J1_X)}) j", rtol=1e-12)


GENERAL_JOINS = {
    # outer joins with aggregates over the NULL side
    "left_grouped_null_side": "SELECT medium.id4, count(*) AS c, "
                              "sum(x.v1) AS s, count(v2) AS cv, "
                              "avg(v2) AS av, min(v2) AS mn, max(medium.id1) "
                              "AS mx FROM x LEFT JOIN medium USING (id2) "
                              "GROUP BY medium.id4",
    "right_grouped": "SELECT small.id4, count(x.v1) AS c, max(x.v1) AS m "
                     "FROM x RIGHT JOIN small ON x.id1 = small.id1 "
                     "GROUP BY small.id4 ORDER BY small.id4",
    "full_is_null": "SELECT count(*) AS c, count(x.id1) AS cx, "
                    "count(small.id1) AS cs FROM x FULL JOIN small "
                    "ON x.id1 = small.id1",
    "left_anti": "SELECT x.id3, x.id1 FROM x LEFT JOIN small USING (id1) "
                 "WHERE v2 IS NULL ORDER BY x.id3 LIMIT 40",
    # three tables, multi-column keys, derived tables
    "three_tables": "SELECT x.id1, count(*) AS c, sum(big.v2) AS s FROM x, "
                    "big, small WHERE x.id3 = big.id3 AND big.id1 = small.id1 "
                    "GROUP BY x.id1",
    "chained_join": "SELECT medium.id5, count(*) AS c FROM x JOIN medium "
                    "USING (id2) JOIN small ON small.id1 = medium.id1 "
                    "GROUP BY medium.id5",
    "multi_column": "SELECT count(*) AS c, sum(x.v1) AS s FROM x JOIN big "
                    "ON x.id1 = big.id1 AND x.id2 = big.id2 AND "
                    "x.id3 = big.id3",
    "multi_column_using": "SELECT x.id3, big.v2 FROM x JOIN big "
                          "USING (id1, id2) ORDER BY x.id3, big.v2 LIMIT 50",
    "derived_left": "SELECT t.id1, count(*) AS c FROM (SELECT id1, id2 FROM x "
                    "WHERE v1 > 50) t JOIN medium USING (id2) GROUP BY t.id1",
    "derived_right": "SELECT x.id1, sum(s.v2) AS sv FROM x JOIN (SELECT id1, "
                     "v2 FROM small WHERE v2 > 20) s ON x.id1 = s.id1 "
                     "GROUP BY x.id1",
    "comma_residual": "SELECT count(*) AS c FROM x, medium WHERE "
                      "x.id2 = medium.id2 AND x.v1 > medium.v2",
    # duplicate keys, strings in two dictionaries, natural join
    "duplicate_keys": "SELECT x.id3, medium.id2, medium.v2 FROM x JOIN medium "
                      "ON x.id1 = medium.id1 WHERE x.id3 < 40",
    "string_keys": "SELECT x.id4, count(*) AS c FROM x JOIN small "
                   "ON x.id4 = small.id4 GROUP BY x.id4",
    "natural": "SELECT count(*) AS c FROM small NATURAL JOIN medium",
}


@pytest.mark.parametrize("name", sorted(GENERAL_JOINS))
def test_general_joins_match_jax(name, j1):
    _tables, (js, ts) = j1
    _same_rows(js, ts, GENERAL_JOINS[name], rtol=1e-12)


def test_star_over_using_join_matches_numpy(j1):
    """SELECT * over a USING join: the key once, then every other column of
    both sides, a repeated name suffixed _1. The JAX package keeps one
    column per name and drops medium's id4 and v2 (ROADMAP queue 3), so
    numpy holds this shape."""
    tables, (_js, ts) = j1
    (sa, sd), (ma, md) = tables["small"], tables["medium"]
    r = ts.execute("SELECT * FROM small JOIN medium USING (id1) "
                   "ORDER BY small.v2, medium.v2")
    assert r.column_names() == ["id1", "id4", "v2", "id2", "id4_1", "id5",
                                "v2_1"]
    i, j = np.nonzero(sa["id1"][:, None] == ma["id1"][None, :])
    order = np.lexsort((ma["v2"][j], sa["v2"][i]))
    i, j = i[order], j[order]

    def dec(d, codes):
        return [d.strings()[c] for c in codes]
    assert r.rows() == list(zip(
        sa["id1"][i].tolist(), dec(sd["id4"], sa["id4"][i]),
        sa["v2"][i].tolist(), ma["id2"][j].tolist(),
        dec(md["id4"], ma["id4"][j]), dec(md["id5"], ma["id5"][j]),
        ma["v2"][j].tolist()))


def _fault_tables():
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.execute("CREATE TABLE e(a INT, c INT, s VARCHAR(10))")
    ts.execute("CREATE TABLE t(a INT, c INT)")
    ts.execute("INSERT INTO t VALUES (1, 2), (3, 4)")
    ts.execute("CREATE TABLE t3(a INT, b INT, s VARCHAR(5))")
    ts.execute("INSERT INTO t3 VALUES (1, 2, 'tx'), (3, 4, 'ty')")
    ts.execute("CREATE TABLE u(a INT, s VARCHAR(5))")
    ts.execute("INSERT INTO u VALUES (1, 'up'), (5, 'uq')")
    ts.execute("CREATE TABLE v(a INT, w INT)")
    ts.execute("INSERT INTO v VALUES (1, 10), (6, 60)")
    ts.execute("CREATE TABLE p(a INT, z INT)")
    ts.execute("INSERT INTO p VALUES (1, 7), (5, 8)")
    return ts


EMPTY_DICTIONARY = {
    "left_join": ("SELECT t.a, e.s FROM t LEFT JOIN e ON t.a = e.a",
                  ["a", "s"], [(1, None), (3, None)]),
    "right_join_star": ("SELECT * FROM e RIGHT JOIN t ON t.a = e.a",
                        ["a", "c", "s", "a_1", "c_1"],
                        [(None, None, None, 1, 2), (None, None, None, 3, 4)]),
    "count": ("SELECT count(e.s) AS n FROM t LEFT JOIN e ON t.a = e.a",
              ["n"], [(0,)]),
}


@pytest.mark.parametrize("case", sorted(EMPTY_DICTIONARY))
def test_null_strings_of_an_empty_dictionary_follow_sql(case):
    """An empty table's string column read through an outer join: NULL in
    every row (the JAX package raises IndexError, ROADMAP queue 3)."""
    sql, names, rows = EMPTY_DICTIONARY[case]
    r = _fault_tables().execute(sql)
    assert (r.column_names(), r.rows()) == (names, rows)


STAR_JOINS = {
    "on": ("SELECT * FROM t3 JOIN u ON t3.a = u.a",
           ["a", "b", "s", "a_1", "s_1"], [(1, 2, "tx", 1, "up")]),
    "right_using": ("SELECT * FROM u RIGHT JOIN t3 USING (a)",
                    ["a", "s", "b", "s_1"],
                    [(1, "up", 2, "tx"), (3, None, 4, "ty")]),
    "full_using": ("SELECT * FROM t3 FULL JOIN u USING (a)",
                   ["a", "b", "s", "s_1"],
                   [(1, 2, "tx", "up"), (3, 4, "ty", None),
                    (5, None, None, "uq")]),
    "full_using_strings": ("SELECT * FROM t3 FULL JOIN u USING (a, s)",
                           ["a", "b", "s"],
                           [(1, 2, "tx"), (3, 4, "ty"), (1, None, "up"),
                            (5, None, "uq")]),
    "natural": ("SELECT * FROM t3 NATURAL JOIN u", ["a", "b", "s"], []),
    "chained_using": ("SELECT * FROM u FULL JOIN v USING (a) JOIN p "
                      "USING (a)", ["a", "s", "w", "z"],
                      [(1, "up", 10, 7), (5, "uq", None, 8)]),
    "qualified": ("SELECT u.* FROM u RIGHT JOIN t3 USING (a)", ["a", "s"],
                  [(1, "up"), (None, None)]),
}


@pytest.mark.parametrize("case", sorted(STAR_JOINS))
def test_star_over_joins_follows_sql(case):
    """SELECT * keeps every column of an ON join; a NATURAL or USING key
    comes once, as COALESCE(left, right) under RIGHT and FULL (the JAX
    package keeps one column per name, ROADMAP queue 3)."""
    sql, names, rows = STAR_JOINS[case]
    r = _fault_tables().execute(sql)
    assert (r.column_names(), r.rows()) == (names, rows)


def test_joins_over_null_keys_match_jax():
    """NULL keys on either side match nothing; an outer join keeps their
    rows with a NULL other side."""
    rng = np.random.default_rng(4)
    lk = np.ma.masked_array(rng.integers(0, 6, 60).astype(np.int32),
                            mask=rng.random(60) < 0.2)
    rk = np.ma.masked_array(rng.integers(0, 6, 25).astype(np.int32),
                            mask=rng.random(25) < 0.2)
    js, ts = _load_any({"l": {"k": lk, "a": np.arange(60, dtype=np.int32)},
                        "r": {"k": rk, "b": np.arange(25, dtype=np.int32)}})
    for kind in ("", "LEFT", "RIGHT", "FULL"):
        _same_rows(js, ts, f"SELECT a, b FROM l {kind} JOIN r ON l.k = r.k")
    got = ts.execute("SELECT count(*) FROM l JOIN r ON l.k = r.k").rows()
    lv, rv = lk.compressed(), rk.compressed()
    assert got == [(int((lv[:, None] == rv[None, :]).sum()),)]


def test_join_hash_collisions_are_dropped(monkeypatch):
    """With a hash that collides almost everywhere, the key comparison
    still keeps exactly the equal pairs, in left-then-right order."""
    from aquery2_tpu_torch.engine import join as TJ

    rng = np.random.default_rng(8)
    lk = rng.integers(0, 40, 300).astype(np.int32)
    rk = rng.integers(0, 40, 90).astype(np.int32)
    lk2 = rng.integers(0, 3, 300).astype(np.int32)
    rk2 = rng.integers(0, 3, 90).astype(np.int32)
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.catalog.create(TTable.from_numpy("l", {"k": lk, "j": lk2}, device="cpu"))
    ts.catalog.create(TTable.from_numpy("r", {"k": rk, "j": rk2}, device="cpu"))
    monkeypatch.setattr(TJ, "_key_hash",
                        lambda cols: cols[0].to(torch.int64) % 3)
    pairs = [(i, j) for i in range(300) for j in range(90)
             if lk[i] == rk[j] and lk2[i] == rk2[j]]
    ts.execute("CREATE TABLE lr AS SELECT l.k AS lk, r.k AS rk, l.j AS lj, "
               "r.j AS rj FROM l JOIN r ON l.k = r.k AND l.j = r.j")
    got = ts.execute("SELECT lk, rk, lj, rj FROM lr").rows()
    assert got == [(int(lk[i]), int(rk[j]), int(lk2[i]), int(rk2[j]))
                   for i, j in pairs]
    left = ts.execute("SELECT count(*) FROM l LEFT JOIN r "
                      "ON l.k = r.k AND l.j = r.j").rows()
    hit = {i for i, _j in pairs}
    assert left == [(len(pairs) + 300 - len(hit),)]


def test_joins_the_jax_package_refuses_raise():
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.execute("CREATE TABLE a(k INT); CREATE TABLE b(k INT);"
               "INSERT INTO a VALUES (1), (2); INSERT INTO b VALUES (2)")
    with pytest.raises(TE.ExecError, match="CROSS JOIN not supported"):
        ts.execute("SELECT * FROM a CROSS JOIN b")
    with pytest.raises(TE.ExecError, match="without a connecting equality"):
        ts.execute("SELECT a.k FROM a, b WHERE a.k > b.k")
