"""The sort tiers and nullable columns through both packages: the JAX
package (aquery2_tpu.connect()) and the port (aquery2_tpu_torch.connect
("cpu")) get identical tables from one numpy seed and must return the same
column names, SQL types, row order and values.

Covered: the multikey tier (computed keys, float keys, integer keys wider
than 30 bits), packed keys of 3 and 4 words, min/max of bool, int8, int16,
int64 and float64 in the packed tier, and nullable keys and arguments in
the dense and packed tiers. Values are compared exactly, except results
through sqrt or pow (SQRT_RTOL, the last-ulp difference of XLA's and
torch's float64 sqrt) and float64 sums (F64_SUM_RTOL, another order of
summation).

Three JAX-package faults are held to numpy oracles instead: each NaN of a
float group key makes its own group there (the port makes one NaN group,
last); two or more int8/int16 min/max lanes raise there; and a key of two
or more packed words with a small-range integer argument splits groups
there (the carrier embed), which the port does not port."""

import numpy as np
import pytest
import torch

import aquery2_tpu
from aquery2_tpu import config as JC
from aquery2_tpu import types as JT
from aquery2_tpu.engine import fused_groupby as JF
from aquery2_tpu.parser import parse as jparse
from aquery2_tpu.storage.table import Column as JColumn, Table as JTable

import aquery2_tpu_torch
from aquery2_tpu_torch import config as TC
from aquery2_tpu_torch.engine import fused_groupby as TF
from aquery2_tpu_torch.ops.sort import lexsort
from aquery2_tpu_torch.parser import parse as tparse
from aquery2_tpu_torch.storage.table import Table as TTable
from aquery2_tpu_torch.utils.datagen import H2O_COLUMNS, h2o_g1

SQRT_RTOL = 1e-15
F64_SUM_RTOL = 1e-12
N = 6000


def _jtype(arr):
    return JT.from_np_dtype(arr.dtype)


def _sessions(tables):
    """Both packages over {name: {col: array or masked array}}."""
    js = aquery2_tpu.connect()
    ts = aquery2_tpu_torch.connect(device="cpu")
    for name, cols in tables.items():
        jcols = []
        for nm, arr in cols.items():
            valid = None
            if isinstance(arr, np.ma.MaskedArray):
                valid = ~np.ma.getmaskarray(arr)
                arr = arr.filled(0)
            jcols.append(JColumn(nm, _jtype(arr), arr, valid=valid))
        ref = JTable(name, jcols)
        js.catalog.create(ref)
        ts.catalog.create(TTable.from_reference(ref, device="cpu"))
    return js, ts


def _compare(jr, tr, close=None):
    close = close or {}
    assert tr.column_names() == jr.column_names()
    assert tr.nrows == jr.nrows > 0
    for jc, tc in zip(jr.table.columns.values(), tr.table.columns.values()):
        assert tc.sqltype.name == jc.sqltype.name, tc.name
        jv = np.asarray(jc.data)[:jc.nrows]
        tv = tc.to_numpy()
        assert tv.dtype == jv.dtype, tc.name
        if tc.name in close:
            np.testing.assert_allclose(tv, jv, rtol=close[tc.name], atol=0,
                                       err_msg=tc.name)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=tc.name)
    assert [c.to_python() for c in tr.table.columns.values()
            if c.name not in close] == \
        [c.to_python() for c in jr.table.columns.values()
         if c.name not in close]


def _tiers(js, ts, sql, table):
    jsel, = jparse(sql)
    tsel, = tparse(sql)
    jt, tt = js.catalog.get(table), ts.catalog.get(table)
    return (JF.choose_strategy(JF.plan(jsel, jt), jt.columns)[0],
            TF.choose_strategy(TF.plan(tsel, tt), tt.columns)[0])


@pytest.fixture(scope="module")
def base():
    rng = np.random.default_rng(4242)
    src = {
        "id1": rng.integers(1, 11, N).astype(np.int32),
        "id2": rng.integers(1, 11, N).astype(np.int32),
        "id3": rng.integers(1, 501, N).astype(np.int32),
        "v1": rng.integers(1, 6, N).astype(np.int32),
        "v2": rng.integers(1, 16, N).astype(np.int32),
        "v3": np.round(rng.random(N) * 100, 6).astype(np.float32),
        "w": rng.normal(size=N) * 1e3,
    }
    wide = {"a": rng.integers(-50, 50, N).astype(np.int64) * (1 << 33),
            "b": rng.integers(0, 3, N).astype(np.int32),
            "v": rng.integers(-100, 100, N).astype(np.int32)}
    n6 = 8192
    g6 = {nm: rng.integers(1, 11, n6).astype(np.int32)
          for nm in ("id1", "id2", "id4", "id5")}
    for nm in ("id3", "id6"):
        g6[nm] = rng.integers(1, 16_000_001, n6).astype(np.int32)
        g6[nm][:2] = (1, 16_000_000)        # full 24-bit ranges: 3 words
    g6["id7"] = rng.integers(0, 1 << 29, n6).astype(np.int32)   # 4 words
    g6["v3"] = np.round(rng.random(n6) * 100, 6).astype(np.float32)
    g6["v1"] = rng.integers(-5, 6, n6).astype(np.int32)
    for nm in ("id3", "id6", "id7"):        # duplicate key tuples
        g6[nm][n6 // 2:] = g6[nm][:n6 // 2]
    for nm in ("id1", "id2", "id4", "id5"):
        g6[nm][n6 // 2:] = g6[nm][:n6 // 2]
    k = rng.integers(0, 1000, N).astype(np.int32)
    types = {"k": k, "b": rng.random(N) < 0.5,
             "i8": rng.integers(-128, 128, N).astype(np.int8),
             "i16": rng.integers(-2**15, 2**15, N).astype(np.int16),
             "i64": rng.integers(-2**62, 2**62, N),
             "f64": rng.normal(size=N)}
    return {"source": src, "wk": wide, "g6": g6, "ty": types}


@pytest.fixture(scope="module")
def sessions(base):
    return _sessions(base)


MULTIKEY = {
    "expr_key": ("SELECT id1+id2 AS k, sum(v1) AS s FROM source "
                 "GROUP BY id1+id2", "source"),
    "expr_key_having_order": (
        "SELECT id1*10+id2 AS k, count(*) AS c FROM source "
        "GROUP BY id1*10+id2 HAVING count(*) > 0 ORDER BY c DESC", "source"),
    "expr_key_aggs": (
        "SELECT id1 * 100 + id2 AS k, sum(v1) AS s, max(v3) AS mx, "
        "min(v2) AS mn, avg(v3) AS a, var(v2) AS vr, corr(v1, v2) AS r "
        "FROM source WHERE v2 > 3 GROUP BY id1 * 100 + id2", "source"),
    "expr_two_keys": ("SELECT id3 % 7 AS a, id1, sum(w) AS s, count(*) AS c "
                      "FROM source GROUP BY id3 % 7, id1", "source"),
    "float_key": ("SELECT v3 * 2 AS k, count(*) AS c, sum(v1) AS s "
                  "FROM source GROUP BY v3 * 2", "source"),
    "float_key_desc_order": ("SELECT v1 / 2 AS k, max(v3) AS mx FROM source "
                             "GROUP BY v1 / 2 ORDER BY k DESC", "source"),
    "wide_key": ("SELECT a, sum(v) AS s, min(v) AS mn FROM wk GROUP BY a",
                 "wk"),
    "wide_two_keys": ("SELECT a, b, sum(v) AS s, count(*) AS c FROM wk "
                      "GROUP BY a, b", "wk"),
    "three_words": ("SELECT id1, id2, id3, id4, id5, id6, sum(v3) AS sv, "
                    "count(*) AS c FROM g6 GROUP BY id1, id2, id3, id4, id5, "
                    "id6", "g6"),
    "four_words": ("SELECT id3, id6, id7, id1, sum(v3) AS s, max(v3) AS mx "
                   "FROM g6 GROUP BY id3, id6, id7, id1", "g6"),
    "three_words_median": ("SELECT id3, id6, id7, median(v3) AS m, "
                           "count(*) AS c FROM g6 GROUP BY id3, id6, id7",
                           "g6"),
    "minmax_bool": ("SELECT k, min(b) AS mn, max(b) AS mx FROM ty GROUP BY k",
                    "ty"),
    "minmax_i8": "SELECT k, min(i8) AS mn FROM ty GROUP BY k",
    "minmax_i16": "SELECT k, max(i16) AS mx FROM ty GROUP BY k",
    "minmax_i64": ("SELECT k, min(i64) AS mn, max(i64) AS mx FROM ty "
                   "GROUP BY k", "ty"),
    "minmax_f64": ("SELECT k, min(f64) AS mn, max(f64) AS mx, sum(i8) AS s "
                   "FROM ty GROUP BY k", "ty"),
}
MULTIKEY = {k: v if isinstance(v, tuple) else (v, "ty")
            for k, v in MULTIKEY.items()}
TIERS = {"three_words": "packed", "four_words": "packed",
         "three_words_median": "packed", "minmax_bool": "packed",
         "minmax_i8": "packed", "minmax_i16": "packed", "minmax_i64": "packed",
         "minmax_f64": "packed", "wide_key": "packed",
         "wide_two_keys": "packed"}
CLOSE = {"expr_key_aggs": {"r": SQRT_RTOL}, "expr_two_keys": {"s": F64_SUM_RTOL}}


@pytest.mark.parametrize("name", list(MULTIKEY))
def test_sort_tiers_match_jax(name, sessions):
    js, ts = sessions
    sql, table = MULTIKEY[name]
    assert len(set(_tiers(js, ts, sql, table))) == 1
    assert _tiers(js, ts, sql, table)[1] == TIERS.get(name, "multikey")
    _compare(js.execute(sql), ts.execute(sql), CLOSE.get(name))


@pytest.mark.parametrize("sql", [
    "SELECT id1, w, count(*) AS c, sum(v1) AS s FROM source GROUP BY id1, w",
    "SELECT id2, v3, id1, count(*) AS c, max(v2) AS mx FROM source "
    "GROUP BY id2, v3, id1",
    "SELECT w, id3 % 7 AS m, sum(v1) AS s FROM source GROUP BY w, id3 % 7",
])
def test_float_column_keys_match_jax(sql, sessions):
    """A float column key, before, between or after integer keys, takes
    the port's multikey tier; the JAX package answers it in its general
    engine, with the same groups in the same order."""
    js, ts = sessions
    tsel, = tparse(sql)
    tt = ts.catalog.get("source")
    assert TF.choose_strategy(TF.plan(tsel, tt), tt.columns)[0] == "multikey"
    _compare(js.execute(sql), ts.execute(sql))


def test_packed_word_counts(base):
    """The 3- and 4-word cases really span that many packed words."""
    g6 = base["g6"]
    for keys, nwords in ((("id1", "id2", "id3", "id4", "id5", "id6"), 3),
                         (("id3", "id6", "id7", "id1"), 4)):
        ranges = [int(g6[k].max()) - int(g6[k].min()) + 1 for k in keys]
        assert TF._plan_words(ranges)[1] == nwords


@pytest.mark.parametrize("sql", [
    "SELECT id1, id2, sum(v1) AS s, count(*) AS c FROM source "
    "GROUP BY id1, id2",
    "SELECT id3, avg(v3) AS a, max(v1) - min(v2) AS rg FROM source "
    "GROUP BY id3",
    "SELECT id1+id2 AS k, sum(v1) AS s FROM source GROUP BY id1+id2",
])
def test_sort_tiers_with_forced_packed(sql, sessions, monkeypatch):
    """test_fused.py's forced packed-sort path (the dense cap shrunk to
    one slot) gives the same answers in both packages."""
    js, ts = sessions
    monkeypatch.setattr(JC, "ONEHOT_MATMUL_MAX_GROUPS", 1)
    monkeypatch.setattr(TC, "ONEHOT_MATMUL_MAX_GROUPS", 1)
    JF._cache.clear()
    try:
        _compare(js.execute(sql), ts.execute(sql))
    finally:
        JF._cache.clear()


def _script_rows(n, rng, cols):
    return ",".join("(" + ",".join(str(c[i]) for c in cols) + ")"
                    for i in range(n))


def _fused_scripts():
    """test_fused.py's single-table cases built from SQL (:187-295,
    :455-477): a DOUBLE median, ORDER BY, HAVING, and a median whose key
    leaves spare bits beside a small-range argument."""
    rng = np.random.default_rng(5)
    g, h = rng.integers(1, 6, 200), rng.integers(1, 4, 200)
    v = np.round(rng.random(200) * 100, 3)
    k = rng.integers(1, 3_000_000, 600)
    sv = rng.integers(1, 9, 600)
    x = np.round(rng.random(600) * 100, 6)
    return {
        "median_double": (
            "CREATE TABLE mt(g INT, h INT, v DOUBLE);"
            f"INSERT INTO mt VALUES {_script_rows(200, rng, (g, h, v))}",
            ["SELECT g, h, median(v) AS m, stddev(v) AS s FROM mt "
             "GROUP BY g, h"]),
        "order_by": (
            "CREATE TABLE ot(g INT, v INT);"
            "INSERT INTO ot VALUES (3,1),(1,10),(1,5),(2,2),(2,9),(3,4)",
            ["SELECT g, sum(v) AS s FROM ot GROUP BY g ORDER BY s DESC",
             "SELECT g, sum(v) AS s FROM ot GROUP BY g ORDER BY sum(v)",
             "SELECT g, sum(v) AS s FROM ot GROUP BY g ORDER BY s DESC "
             "LIMIT 2"]),
        "having": (
            "CREATE TABLE ht(g INT, v INT);"
            "INSERT INTO ht VALUES (1,10),(1,5),(2,2),(2,9),(2,1),(3,4)",
            ["SELECT g, sum(v) AS s FROM ht GROUP BY g HAVING count(*) > 1",
             "SELECT g, sum(v) AS s FROM ht GROUP BY g HAVING sum(v) >= 12 "
             "ORDER BY s"]),
        "median_spare_bits": (
            "CREATE TABLE m1(k INT, v INT, x REAL);"
            f"INSERT INTO m1 VALUES {_script_rows(600, rng, (k, sv, x))}",
            ["SELECT k, median(x) AS mx, sum(v) AS sv FROM m1 GROUP BY k "
             "ORDER BY k"]),
    }


@pytest.mark.parametrize("name", ["median_double", "order_by", "having",
                                  "median_spare_bits"])
def test_fused_scripts_match_jax(name):
    script, queries = _fused_scripts()[name]
    js, ts = aquery2_tpu.connect(), aquery2_tpu_torch.connect(device="cpu")
    js.execute(script)
    ts.execute(script)
    for sql in queries:
        _compare(js.execute(sql), ts.execute(sql),
                 {"s": SQRT_RTOL} if name == "median_double" else None)


def _oracle_groups(keys: list[np.ndarray]):
    """(sorted unique key rows, inverse): lexicographic, NaN last and equal
    to NaN, -0.0 equal to 0.0."""
    cols = []
    for k in keys:
        k = np.where(k == 0, 0, k).astype(k.dtype) if k.dtype.kind == "f" \
            else k
        cols.append(k)
    order = np.lexsort(cols[::-1])
    rows = [c[order] for c in cols]
    new = np.zeros(len(order), bool)
    new[0] = True
    for r in rows:
        same = (r[1:] == r[:-1]) | (np.isnan(r[1:]) & np.isnan(r[:-1])
                                     if r.dtype.kind == "f" else False)
        new[1:] |= ~same
    gid = np.cumsum(new) - 1
    inv = np.empty(len(order), np.int64)
    inv[order] = gid
    return [r[new] for r in rows], inv


def test_nan_float_keys_make_one_group():
    """NaN keys of a computed float key make ONE group, last (the JAX
    package makes one group per NaN row: held to numpy)."""
    rng = np.random.default_rng(3)
    v = rng.choice(np.array([1.0, np.nan, 2.0, -0.0, 0.0, -3.5], np.float32),
                   500)
    w = rng.integers(0, 100, 500).astype(np.int32)
    _js, ts = _sessions({"t": {"v": v, "w": w}})
    r = ts.execute("SELECT v + 0.0 AS k, sum(w) AS s, count(*) AS c, "
                   "min(w) AS mn FROM t GROUP BY v + 0.0")
    (uk,), inv = _oracle_groups([(v + np.float32(0.0)).astype(np.float64)])
    got = r.table.columns
    np.testing.assert_array_equal(got["k"].to_numpy(), uk)
    np.testing.assert_array_equal(got["s"].to_numpy(),
                                  np.bincount(inv, weights=w).astype(np.int64))
    np.testing.assert_array_equal(got["c"].to_numpy(), np.bincount(inv))
    mn = np.full(len(uk), 2**31 - 1)
    np.minimum.at(mn, inv, w)
    np.testing.assert_array_equal(got["mn"].to_numpy(), mn)
    assert np.isnan(uk[-1]) and int(np.isnan(uk).sum()) == 1


def test_narrow_minmax_lanes_numpy():
    """Several int8/int16/bool min/max lanes in one packed query (the JAX
    package raises on two or more narrow lanes: held to numpy)."""
    rng = np.random.default_rng(8)
    n = 4000
    k = rng.integers(0, 700, n).astype(np.int32)
    cols = {"k": k, "a": rng.integers(-128, 128, n).astype(np.int8),
            "b": rng.integers(-2**15, 2**15, n).astype(np.int16),
            "c": rng.random(n) < 0.3}
    _js, ts = _sessions({"t": cols})
    r = ts.execute("SELECT k, min(a) AS mna, max(a) AS mxa, min(b) AS mnb, "
                   "max(b) AS mxb, max(c) AS mxc, min(c) AS mnc FROM t "
                   "GROUP BY k")
    uk, inv = np.unique(k, return_inverse=True)
    got = r.table.columns
    np.testing.assert_array_equal(got["k"].to_numpy(), uk)
    for name, src, fn in (("mna", "a", np.minimum), ("mxa", "a", np.maximum),
                          ("mnb", "b", np.minimum), ("mxb", "b", np.maximum),
                          ("mxc", "c", np.maximum), ("mnc", "c", np.minimum)):
        x = cols[src]
        want = np.full(len(uk), x[0], x.dtype)
        want[inv] = x                  # any member, then fold every member
        fn.at(want, inv, x)
        g = got[name].to_numpy()
        assert g.dtype == x.dtype, name
        np.testing.assert_array_equal(g, want, err_msg=name)


@pytest.mark.parametrize("bits, nwords", [((20, 20), 2),
                                           ((24, 24, 29, 4), 4)])
def test_multiword_key_small_range_argument_numpy(bits, nwords):
    """Keys of two and of four packed words, a small-range int argument
    and duplicate key tuples: each distinct tuple is one group with the
    whole sum (the JAX package's carrier embed splits such groups: held
    to numpy)."""
    rng = np.random.default_rng(9)
    n = 3000
    keys = [np.tile(rng.integers(0, 1 << b, n // 3).astype(np.int32), 3)
            for b in bits]
    for k, b in zip(keys, bits):
        k[:2] = (0, (1 << b) - 1)               # the full field widths
    names = [f"k{i}" for i in range(len(keys))]
    assert TF._plan_words([1 << b for b in bits])[1] == nwords
    v = rng.integers(0, 4, n).astype(np.int32)
    _js, ts = _sessions({"t": {**dict(zip(names, keys)), "v": v}})
    kl = ", ".join(names)
    r = ts.execute(f"SELECT {kl}, sum(v) AS s, max(v) AS mx, count(*) AS c "
                   f"FROM t GROUP BY {kl}")
    uks, inv = _oracle_groups(keys)
    got = r.table.columns
    for nm, uk in zip(names, uks):
        np.testing.assert_array_equal(got[nm].to_numpy(), uk)
    np.testing.assert_array_equal(got["s"].to_numpy(),
                                  np.bincount(inv, weights=v).astype(np.int64))
    np.testing.assert_array_equal(got["c"].to_numpy(), np.bincount(inv))
    mx = np.zeros(len(uks[0]), np.int32)
    np.maximum.at(mx, inv, v)
    np.testing.assert_array_equal(got["mx"].to_numpy(), mx)


def test_float64_minmax_with_nan_numpy():
    """min/max of float64 with NaNs (NaN wins, as jnp.minimum) and of int64
    near the extremes, in the packed tier (a NaN in a float column makes
    the JAX package's fused tiers raise while they read the column's
    stats: held to numpy)."""
    rng = np.random.default_rng(10)
    n = 5000
    k = rng.integers(0, 900, n).astype(np.int32)
    f = rng.normal(size=n)
    f[::53] = np.nan
    i = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    _js, ts = _sessions({"t": {"k": k, "f": f, "i": i}})
    r = ts.execute("SELECT k, min(f) AS mnf, max(f) AS mxf, min(i) AS mni, "
                   "max(i) AS mxi FROM t GROUP BY k")
    uk, inv = np.unique(k, return_inverse=True)
    got = r.table.columns
    for name, x, fn in (("mnf", f, np.minimum), ("mxf", f, np.maximum),
                        ("mni", i, np.minimum), ("mxi", i, np.maximum)):
        want = np.empty(len(uk), x.dtype)
        want[inv] = x
        with np.errstate(invalid="ignore"):
            fn.at(want, inv, x)
        np.testing.assert_array_equal(got[name].to_numpy(), want,
                                      err_msg=name)


# --- nullable columns -------------------------------------------------------

# At K=10 the h2o NA rule NULLs int(10 · NA_PCT / 100) of each
# low-cardinality id's values: 20% NULLs two of them (5% none), so the
# dense-tier cases get NULL keys.
NA_PCT = 20


@pytest.fixture(scope="module")
def null_sessions():
    data = h2o_g1(N, 10, 77, nas=NA_PCT)
    extra = np.random.default_rng(78)
    g = np.ma.masked_array(extra.integers(1, 600, N).astype(np.int32),
                           mask=extra.random(N) < 0.05)
    x = np.ma.masked_array(extra.integers(-9, 9, N).astype(np.int32),
                           mask=np.zeros(N, bool))
    x.mask[g.filled(0) == 7] = True             # group 7: all NULL
    return _sessions({"source": dict(data), "t": {"g": g, "x": x,
                                                  "v3": data["v3"].data}})


NULLABLE = {
    "dense_keys": ("SELECT id1, sum(v1) AS s, count(*) AS c FROM source "
                   "GROUP BY id1", "dense"),
    "dense_two_keys_args": ("SELECT id1, id2, sum(v1) AS s, avg(v3) AS a, "
                            "count(v2) AS cv, min(v2) AS mn FROM source "
                            "GROUP BY id1, id2", "dense"),
    "dense_var_corr": ("SELECT id4, var(v1) AS vr, stddev(v3) AS sd, "
                       "corr(v1, v2) AS r, corr(v3, v2) AS rf FROM source "
                       "GROUP BY id4", "dense"),
    "packed_keys_args": ("SELECT id3, sum(v1) AS s, avg(v3) AS a, "
                         "max(v1) - min(v2) AS rg, count(v3) AS cv, "
                         "count(*) AS c FROM source GROUP BY id3", "packed"),
    "packed_var_corr": ("SELECT id6, var(v2) AS vr, corr(v1, v2) AS r "
                        "FROM source GROUP BY id6", "packed"),
    "packed_six_keys": ("SELECT id1, id2, id3, id4, id5, id6, count(*) AS cnt "
                        "FROM source GROUP BY id1, id2, id3, id4, id5, id6",
                        "packed"),
    "all_null_group": ("SELECT g, sum(x) AS s, min(x) AS mn, max(x) AS mx, "
                       "avg(x) AS a, count(x) AS cx, count(*) AS c FROM t "
                       "GROUP BY g", "packed"),
    "where_plain_col": ("SELECT g, sum(x) AS s FROM t WHERE v3 > 50 "
                        "GROUP BY g", "packed"),
}
NULL_CLOSE = {"dense_var_corr": {"sd": SQRT_RTOL, "r": SQRT_RTOL,
                                 "rf": 1e-12},
              "packed_var_corr": {"r": SQRT_RTOL}}


@pytest.mark.parametrize("name", list(NULLABLE))
def test_nullable_matches_jax(name, null_sessions):
    js, ts = null_sessions
    sql, tier = NULLABLE[name]
    table = "t" if " FROM t " in sql else "source"
    # the JAX package picks its tier from the sentinel-coded table
    tsel, = tparse(sql)
    tt = ts.catalog.get(table)
    p = TF.plan(tsel, tt)
    coded = TF.sentinel_code_null_keys(p, tt)
    assert TF.choose_strategy(p, (coded[0] if coded else tt).columns)[0] \
        == tier
    _compare(js.execute(sql), ts.execute(sql), NULL_CLOSE.get(name))


def test_null_key_group_is_last_and_null(null_sessions):
    _js, ts = null_sessions
    id1 = h2o_g1(N, 10, 77, nas=NA_PCT)["id1"]
    r = ts.execute("SELECT id1, count(*) AS c FROM source GROUP BY id1")
    rows = r.rows()
    assert rows[-1][0] is None and [k for k, _ in rows[:-1]] == \
        sorted(set(id1.compressed().tolist()))
    assert rows[-1][1] == int(id1.mask.sum()) > 0
    assert sum(c for _, c in rows) == N


def test_multiword_key_nullable_arguments_numpy():
    """NULL keys over three packed words with nullable arguments: one
    group per distinct key tuple, NULL keys last in each position, sums
    and counts skipping NULL arguments (the JAX package embeds the
    arguments' NULL bits as carriers in the key words and misorders such
    groups: held to numpy)."""
    data = h2o_g1(N, 10, 77, nas=NA_PCT)
    _js, ts = _sessions({"source": dict(data)})
    ids = ["id1", "id2", "id3", "id4", "id5", "id6"]
    r = ts.execute(f"SELECT {', '.join(ids)}, sum(v1) AS s, count(v3) AS cv, "
                   f"count(*) AS c FROM source GROUP BY {', '.join(ids)}")
    coded = [np.where(data[k].mask, data[k].max() + 1, data[k].data)
             for k in ids]                      # NULL → after every value
    uks, inv = _oracle_groups(coded)
    got = r.table.columns
    for k, uk in zip(ids, uks):
        null = uk == data[k].max() + 1
        assert got[k].to_python() == [None if z else int(u)
                                      for u, z in zip(uk, null)], k
    v1, v3 = data["v1"], data["v3"]
    np.testing.assert_array_equal(
        got["s"].to_numpy(),
        np.bincount(inv, weights=v1.filled(0)).astype(np.int64))
    np.testing.assert_array_equal(
        got["cv"].to_numpy(), np.bincount(inv, weights=~v3.mask).astype(
            np.int64))
    np.testing.assert_array_equal(got["c"].to_numpy(), np.bincount(inv))


@pytest.mark.parametrize("sql, why", [
    ("SELECT id1, sum(v1) AS s FROM source WHERE v2 > 3 GROUP BY id1",
     "nullable WHERE column"),
    ("SELECT id1, median(v3) AS m FROM source GROUP BY id1",
     "nullable median argument"),
    ("SELECT id1, sum(v1 > 2 and v2 < 9) AS s FROM source GROUP BY id1",
     "Kleene logic"),
    ("SELECT id1, sum(id1) AS s FROM source GROUP BY id1",
     "nullable group key"),
])
def test_nullable_general_engine_cases_raise(sql, why, null_sessions):
    """The shapes the fused tiers send to the general engine (the name
    dates from when the port raised for them) answer as the JAX package's
    general engine does; a nullable median skips its NULLs, as SQL does,
    held to numpy (the JAX package sorts them in as zeros: ROADMAP queue
    3)."""
    js, ts = null_sessions
    tr = ts.execute(sql)
    if why != "nullable median argument":
        _compare(js.execute(sql), tr)
        return
    t = ts.catalog.get("source")
    k = t["id1"].to_numpy()
    kok = t["id1"].valid[:t.nrows].numpy()
    v = t["v3"].to_numpy().astype(np.float64)
    vok = t["v3"].valid[:t.nrows].numpy()
    keys = np.unique(k[kok])
    want = [np.median(v[kok & vok & (k == key)]) for key in keys]
    want.append(np.median(v[~kok & vok]))        # the NULL key, last
    assert tr.column_names() == ["id1", "m"]
    assert tr.table["id1"].to_python() == [int(x) for x in keys] + [None]
    np.testing.assert_array_equal(tr.table["m"].to_numpy(), want)


def test_lexsort_packs_and_chains(rng):
    """lexsort against numpy's: one packed sort (bool + bounded int +
    float32), and chains (int64 and float64 keys, DESC)."""
    n = 3000
    b = rng.random(n) < 0.5
    i = rng.integers(-20, 20, n).astype(np.int32)
    f = rng.choice(np.array([-1.5, -0.0, 0.0, 2.0, np.nan], np.float32), n)
    d = rng.choice(np.array([-1.5, -0.0, 0.0, 2.0, np.nan]), n)
    w = rng.integers(-2**40, 2**40, n)

    def key(x, asc):
        if x.dtype.kind == "f":
            x = np.where(x == 0, 0, x).astype(x.dtype)
            return x if asc else -x
        return x.astype(np.int64) if asc else ~x.astype(np.int64)

    for ks in ([(b, True), (i, False, (-20, 19)), (f, True)],
               [(w, False), (d, True), (i, True)],
               [(f, False), (b, False), (d, False), (w, True)]):
        perm, sk = lexsort([(torch.from_numpy(k[0]), *k[1:]) for k in ks])
        want = np.lexsort([key(k[0], k[1]) for k in ks][::-1])
        np.testing.assert_array_equal(perm.numpy(), want)
        for k, s in zip(ks, sk):
            np.testing.assert_array_equal(s.numpy(), k[0][want])


def test_h2o_g1_nas_variant():
    """nas=5 follows groupby-datagen.R after drawing the same values as
    nas=0: id3 and id6 NULL every row of 5% of their distinct values, the
    K=10 ids none (int(10 · 5 / 100) = 0), each v column 5% of its rows,
    independently; both packages load the same NULLs."""
    plain, nas = h2o_g1(N, 10, 5), h2o_g1(N, 10, 5, nas=5)
    masks = []
    for nm in H2O_COLUMNS:
        np.testing.assert_array_equal(np.ma.getdata(nas[nm]), plain[nm])
        if nm in ("id1", "id2", "id4", "id5"):
            assert not isinstance(nas[nm], np.ma.MaskedArray)
            continue
        assert isinstance(nas[nm], np.ma.MaskedArray)
        if nm.startswith("id"):
            u = np.unique(plain[nm])
            nulled = np.unique(plain[nm][nas[nm].mask])
            assert len(nulled) == len(u) * 5 // 100 > 0
            np.testing.assert_array_equal(nas[nm].mask,
                                          np.isin(plain[nm], nulled))
        else:
            assert int(nas[nm].mask.sum()) == N * 5 // 100
            masks.append(nas[nm].mask)
    assert not all(np.array_equal(masks[0], m) for m in masks[1:])
    a = TTable.from_numpy("s", nas, device="cpu")
    _js, ts = _sessions({"s": nas})
    b = ts.catalog.get("s")
    for nm in H2O_COLUMNS:
        assert (a[nm].valid is None) == (b[nm].valid is None), nm
        if a[nm].valid is not None:
            assert torch.equal(a[nm].valid, b[nm].valid)
        assert torch.equal(a[nm].data, b[nm].data)
