"""The h2o group-by slice through both packages: the JAX package
(aquery2_tpu.connect()) and the port (aquery2_tpu_torch.connect("cpu"))
get identical G1-shaped tables from one numpy seed and must return the
same column names, SQL types, row order and values.

Values are compared exactly, floats included: float sums are integer
limb sums in both packages (the add_float split), recombined by the same
float64 arithmetic, and averages divide by the same counts. Two kinds of
results are compared to a tolerance instead (CLOSE): those that pass
through sqrt or pow (stddev, corr, pow) take rtol 1e-15, for the last-ulp
difference of XLA's and torch's float64 sqrt and XLA's fused multiply-adds;
float64 sums take rtol 1e-12, for another order of summation."""

import numpy as np
import pytest
import torch

import aquery2_tpu
from aquery2_tpu import types as JT
from aquery2_tpu.engine import fused_groupby as JF
from aquery2_tpu.ops.sort import sort_perm as jsort_perm
from aquery2_tpu.parser import parse as jparse
from aquery2_tpu.storage.table import Column as JColumn, Table as JTable

import aquery2_tpu_torch
import chip_smoke
from aquery2_tpu_torch.engine import fused_groupby as TF
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops import reduce as TR
from aquery2_tpu_torch.ops.sort import sort_perm as tsort_perm
from aquery2_tpu_torch.parser import parse as tparse
from aquery2_tpu_torch.storage.table import Table as TTable
from aquery2_tpu_torch.utils.datagen import H2O_COLUMNS, h2o_g1
from bench import QUERIES

N = 3 * 2 ** 14
SEED = 20240

CASES = {
    **{q: QUERIES[q] for q in ("q1", "q2", "q3", "q4", "q5", "q6", "q7",
                               "q9", "q10")},
    "where": ("SELECT id6, sum(v1) AS v1, avg(v3) AS v3, count(*) AS c "
              "FROM source WHERE v2 > 7 AND v3 < 60.5 GROUP BY id6"),
    "having": ("SELECT id1, id2, sum(v1) AS v1, max(v3) AS mx FROM source "
               "GROUP BY id1, id2 HAVING avg(v3) > 50"),
    "having_packed": ("SELECT id3, min(v3) AS mn, sum(v2) AS v2 FROM source "
                      "GROUP BY id3 HAVING count(*) >= 11"),
    "var_dense": ("SELECT id1, var(v2) AS vi, stddev(v1) AS si, var(v3) AS vf, "
                  "stddev(v3) AS sf FROM source GROUP BY id1"),
    "var_packed": ("SELECT id3, var(v2) AS vi, stddev(v1) AS si, var(v3) AS vf, "
                   "stddev(v3) AS sf FROM source GROUP BY id3"),
    "corr_float": "SELECT id6, corr(v3, v2) AS r FROM source GROUP BY id6",
    "corr_float_dense": ("SELECT id4, corr(v3, v3 + v1) AS r, corr(v1, v2) AS "
                         "ri FROM source GROUP BY id4"),
    "median_int": ("SELECT id1, median(v1) AS m, sum(v2) AS s FROM source "
                   "GROUP BY id1"),
    "median_two_words": ("SELECT id3, id6, id1, id2, median(v3) AS m, "
                         "stddev(v3) AS sd FROM source "
                         "GROUP BY id3, id6, id1, id2"),
    "f64_sum_dense": ("SELECT id1, sum(w) AS s, avg(w) AS a, sum(v3) AS s3 "
                      "FROM source GROUP BY id1"),
    # the packed tier's float64 sum is a difference of running totals, so
    # its rounding scales with the running total: groups of ~5k rows (the
    # median puts id1 in the packed tier) keep the total within ~10x of
    # a group's sum
    "f64_sum_packed": ("SELECT id1, sum(w) AS s, median(v1) AS m FROM source "
                       "GROUP BY id1"),
    "order_agg_desc": ("SELECT id6, sum(v1) AS s FROM source GROUP BY id6 "
                       "ORDER BY s DESC, id6 LIMIT 25"),
    "order_agg_asc": ("SELECT id1, id2, avg(v3) AS a FROM source "
                      "GROUP BY id1, id2 ORDER BY a LIMIT 10"),
    "order_having": ("SELECT id2, id4, pow(corr(v1, v2), 2) AS r2 FROM source "
                     "GROUP BY id2, id4 HAVING count(*) > 480 "
                     "ORDER BY id4 DESC, r2"),
}
TIERS = {"q1": "dense", "q2": "dense", "q4": "dense", "q9": "dense",
         "having": "dense", "var_dense": "dense", "corr_float_dense": "dense",
         "f64_sum_dense": "dense", "order_agg_asc": "dense",
         "order_having": "dense",
         "q3": "packed", "q5": "packed", "q6": "packed", "q7": "packed",
         "q10": "packed", "where": "packed", "having_packed": "packed",
         "var_packed": "packed", "corr_float": "packed",
         "median_int": "packed", "median_two_words": "packed",
         "f64_sum_packed": "packed", "order_agg_desc": "packed"}
SQRT_RTOL = 1e-15        # results through sqrt or pow
F64_SUM_RTOL = 1e-12     # float64 sums: another order of summation
CLOSE = {
    "q6": {"sd": SQRT_RTOL}, "q9": {"r2": SQRT_RTOL},
    "var_dense": {"si": SQRT_RTOL, "sf": SQRT_RTOL},
    "var_packed": {"si": SQRT_RTOL, "sf": SQRT_RTOL},
    "corr_float": {"r": SQRT_RTOL},
    "corr_float_dense": {"r": SQRT_RTOL, "ri": SQRT_RTOL},
    "median_two_words": {"sd": SQRT_RTOL},
    "f64_sum_dense": {"s": F64_SUM_RTOL, "a": F64_SUM_RTOL},
    "f64_sum_packed": {"s": F64_SUM_RTOL},
    "order_having": {"r2": SQRT_RTOL},
}


@pytest.fixture(scope="module")
def data():
    return h2o_g1(N, 10, SEED)


@pytest.fixture(scope="module")
def sessions(data):
    """Both packages over the G1 columns plus w, a float64 column."""
    js = aquery2_tpu.connect()
    w = (data["v3"].astype(np.float64) * 1.25
         + np.random.default_rng(SEED).random(N) * 1e-3)
    ref = JTable("source", [
        JColumn(nm, JT.FloatT if nm == "v3" else JT.IntT, data[nm])
        for nm in H2O_COLUMNS] + [JColumn("w", JT.DoubleT, w)])
    js.catalog.create(ref)
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.catalog.create(TTable.from_reference(ref, device="cpu"))
    return js, ts


def test_h2o_g1_shape(data):
    assert list(data) == list(H2O_COLUMNS)
    for nm in ("id1", "id2", "id4", "id5"):
        assert data[nm].dtype == np.int32
        assert data[nm].min() == 1 and data[nm].max() == 10
    for nm in ("id3", "id6"):
        assert data[nm].min() >= 1 and data[nm].max() <= N // 10
    assert data["v1"].min() == 1 and data["v1"].max() == 5
    assert data["v2"].min() == 1 and data["v2"].max() == 15
    assert data["v3"].dtype == np.float32
    assert 0 <= data["v3"].min() and data["v3"].max() <= 100
    np.testing.assert_array_equal(data["v3"], np.round(data["v3"], 6))
    again = h2o_g1(N, 10, SEED)
    for nm in H2O_COLUMNS:
        np.testing.assert_array_equal(data[nm], again[nm])


def test_from_reference_equals_from_numpy(sessions, data):
    _js, ts = sessions
    a = ts.catalog.get("source")
    b = TTable.from_numpy("source", data, device="cpu")
    assert a.column_names() == [*b.column_names(), "w"]
    assert a.columns["w"].data.dtype == torch.float64
    for nm in H2O_COLUMNS:
        ca, cb = a.columns[nm], b.columns[nm]
        assert ca.sqltype == cb.sqltype and ca.nrows == cb.nrows == N
        assert torch.equal(ca.data, cb.data)
        assert ca.stats() == cb.stats()


@pytest.mark.parametrize("name", list(CASES))
def test_query_matches_jax(name, sessions):
    js, ts = sessions
    sql = CASES[name]

    jsel, = jparse(sql)
    tsel, = tparse(sql)
    jtab, ttab = js.catalog.get("source"), ts.catalog.get("source")
    jtier = JF.choose_strategy(JF.plan(jsel, jtab), jtab.columns)[0]
    ttier = TF.choose_strategy(TF.plan(tsel, ttab), ttab.columns)[0]
    assert jtier == ttier == TIERS[name]

    _assert_equal(js.execute(sql), ts.execute(sql), CLOSE.get(name, {}),
                  name)


def _assert_equal(jr, tr, close, name):
    """The port's Result equal to the JAX package's: names, SQL types, row
    order and values, exactly but for the columns in close (rtol)."""
    assert tr.column_names() == jr.column_names()
    assert tr.nrows == jr.nrows > 0
    for jc, tc in zip(jr.table.columns.values(), tr.table.columns.values()):
        assert tc.sqltype.name == jc.sqltype.name, tc.name
        jv = np.asarray(jc.data)[:jc.nrows]
        tv = tc.to_numpy()
        assert tv.dtype == jv.dtype, tc.name
        if tc.name in close:
            np.testing.assert_allclose(tv, jv, rtol=close[tc.name], atol=0,
                                       err_msg=f"{name}.{tc.name}")
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=f"{name}.{tc.name}")
    if not close:
        assert tr.rows() == jr.rows()


# --- the G1_1e8 plan at a small size ------------------------------------------
# G1_1e8's id3 and id6 take values in [1, 1e7] (24 bits), so q10's six keys
# pack into three 30-bit words and its lexsort takes two stable int64
# passes; at 1e7 they span [1, 1e6] (20 bits): two words, one pass. Both
# here over N_WIDE rows, with both ends of each span present.
N_WIDE = 200_000
G1_Q = ("q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10")
SCAN_KERNELS = ("seg_cumsum_i64", "seg_scan_multi", "onehot_segment_sums")


def _wide(hi):
    data = h2o_g1(N_WIDE, 10, SEED)
    rng = np.random.default_rng(SEED + 1)
    for nm in ("id3", "id6"):
        data[nm] = rng.integers(1, hi + 1, N_WIDE).astype(np.int32)
        data[nm][[7, 11]] = (1, hi)
    return data


@pytest.fixture(scope="module")
def wide():
    """{id span: (arrays, the port's session)} at spans 1e7 and 1e6, and
    the JAX package's session over the 1e7 arrays."""
    out = {}
    for hi in (10**7, 10**6):
        data = _wide(hi)
        ts = aquery2_tpu_torch.connect(device="cpu")
        ts.catalog.create(TTable.from_numpy("source", data, device="cpu"))
        out[hi] = (data, ts)
    js = aquery2_tpu.connect()
    js.catalog.create(JTable("source", [
        JColumn(nm, JT.FloatT if nm == "v3" else JT.IntT, out[10**7][0][nm])
        for nm in H2O_COLUMNS]))
    return out, js


def _planned(ts, sql, monkeypatch):
    """(result, chip_smoke.PlanProbe of the run, calls of each kernel
    wrapper: on CPU tensors each takes its plain version)."""
    calls = dict.fromkeys(SCAN_KERNELS, 0)
    for name in SCAN_KERNELS:
        def counted(*a, _real=getattr(K, name), _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, counted)
    with chip_smoke.PlanProbe() as plan:
        res = ts.execute(sql)
    monkeypatch.undo()
    return res, plan, {k: v for k, v in calls.items() if v}


@pytest.mark.parametrize("q", G1_Q)
def test_g1_1e8_plan_at_a_small_size(q, wide, monkeypatch):
    """At G1_1e8's id spans each query takes the tier and the kernel calls
    it takes at 1e7's, q10 plans 3 key words and 2 sort passes (2 and 1 at
    1e7's), and the answer equals the JAX package's and numpy's
    (chip_smoke's oracle, under its own check)."""
    sessions, js = wide
    data, ts = sessions[10**7]
    sql = QUERIES[q]
    res, plan, calls = _planned(ts, sql, monkeypatch)
    _r, plan7, calls7 = _planned(sessions[10**6][1], sql, monkeypatch)
    assert plan.tiers == plan7.tiers and plan.tiers
    assert calls == calls7 and calls
    assert plan.fits == plan7.fits
    if q == "q10":
        assert (plan.words, plan.sorts) == ({3}, 2)
        assert (plan7.words, plan7.sorts) == ({2}, 1)
    else:
        assert (plan.words, plan.sorts) == (plan7.words, plan7.sorts)
    jr = js.execute(sql)
    if q == "q8":
        assert res.column_names() == jr.column_names()
        assert res.rows() == jr.rows()
        chip_smoke.check_q8(res, data)
    else:
        _assert_equal(jr, res, CLOSE.get(q, {}), q)
        chip_smoke.check_result(q, res, *chip_smoke.oracle(data, q))


def test_unported_shapes_raise(sessions):
    """Shapes the port once declined (the name dates from then) answer as
    the JAX package's general engine does, except a nullable median, which
    skips its NULL as SQL does (the JAX package sorts it in as 0: ROADMAP
    queue 3)."""
    js, ts = sessions
    for db in (js, ts):
        db.execute("CREATE TABLE nul(a INT, b INT, k BIGINT);"
                   "INSERT INTO nul VALUES (1, NULL, 0), "
                   "(2, 3, 1099511627776), (1, 4, 7)")
    for sql in ("SELECT a, sum(b) AS s FROM nul WHERE b > 1 GROUP BY a",
                "SELECT b, sum(b) AS s FROM nul GROUP BY b",
                "SELECT id1, subvec(v1, 0, 2) FROM source GROUP BY id1 "
                "ORDER BY id1",
                "SELECT count(*) FROM source"):
        jr, tr = js.execute(sql), ts.execute(sql)
        assert tr.column_names() == jr.column_names(), sql
        assert [c.sqltype.name for c in tr.table.columns.values()] == \
            [c.sqltype.name for c in jr.table.columns.values()], sql
        assert tr.rows() == jr.rows(), sql
    r = ts.execute("SELECT a, median(b) AS m FROM nul GROUP BY a")
    assert r.rows() == [(1, 4.0), (2, 3.0)]


def test_packed_tier_on_cpu_launches_nothing(sessions):
    """CPU tensors take the kernels' plain versions: no launches."""
    _js, ts = sessions
    before = dict(K.LAUNCHES)
    ts.execute(CASES["q7"])
    assert K.LAUNCHES == before


@pytest.mark.parametrize("name", ["q1", "q9"])
def test_dense_tier_on_cpu_launches_nothing(name, sessions):
    """The dense tier's sums take onehot_segment_sums' plain version on
    CPU tensors: no launches."""
    _js, ts = sessions
    before = dict(K.LAUNCHES)
    ts.execute(CASES[name])
    assert K.LAUNCHES == before


def _sort_keys(rng, n):
    """Integer, bool and float keys with ties, NaN, -0.0 and 0.0."""
    f = rng.choice(np.array([-1.5, -0.0, 0.0, 2.0, np.nan, np.inf],
                            np.float32), n)
    return [rng.integers(-3, 3, n).astype(np.int32), rng.random(n) < 0.5,
            f, rng.integers(0, 4, n)]


@pytest.mark.parametrize("dirs", [(True, False, True, False),
                                  (False, True, False, True),
                                  (True, True, False, True)])
def test_sort_perm_matches_jax(dirs, rng):
    n = 777
    keys = _sort_keys(rng, n)
    got = tsort_perm([(torch.from_numpy(k), a) for k, a in zip(keys, dirs)],
                     n - 40)
    want = jsort_perm([(np.asarray(k), a) for k, a in zip(keys, dirs)],
                      n - 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sql", [
    "SELECT s, sum(b) AS sb, min(c) AS mn, count(*) AS n FROM t GROUP BY s",
    "SELECT a, s, avg(c) AS ac FROM t GROUP BY a, s HAVING sum(b) > 0 LIMIT 3",
    "SELECT a, max(b) - min(b) AS r FROM t WHERE c < 3.5 GROUP BY a",
])
def test_ddl_and_insert_match_jax(sql):
    """CREATE TABLE + INSERT … VALUES, a string key, HAVING and LIMIT."""
    script = ("CREATE TABLE t(a INT, s VARCHAR(8), b BIGINT, c REAL);"
              "INSERT INTO t VALUES (2,'x',5,1.5),(1,'y',-3,2.25),"
              "(2,'x',7,-0.5),(3,'z',1,4.0),(1,'x',-2,3.0),(3,'y',9,0.125)")
    js, ts = aquery2_tpu.connect(), aquery2_tpu_torch.connect(device="cpu")
    js.execute(script)
    ts.execute(script)
    jr, tr = js.execute(sql), ts.execute(sql)
    assert tr.column_names() == jr.column_names()
    assert [c.sqltype.name for c in tr.table.columns.values()] == \
        [c.sqltype.name for c in jr.table.columns.values()]
    assert tr.rows() == jr.rows()


@pytest.mark.parametrize("sql", [
    "SELECT s, sum(b) AS sb, count(*) AS n FROM t GROUP BY s ORDER BY s LIMIT 3",
    "SELECT s, a, max(c) AS mc FROM t GROUP BY s, a ORDER BY s DESC, a DESC",
    "SELECT a, sum(b) AS sb FROM t GROUP BY a ORDER BY sb DESC LIMIT 2",
    "SELECT a, s, avg(c) AS ac FROM t GROUP BY a, s ORDER BY ac, s LIMIT 4",
])
def test_order_by_matches_jax(sql):
    """ORDER BY ASC/DESC on an aggregate and on a string key (dictionary
    rank, not code: the strings arrive out of order), with LIMIT."""
    script = ("CREATE TABLE t(a INT, s VARCHAR(8), b BIGINT, c REAL);"
              "INSERT INTO t VALUES (2,'pear',5,1.5),(1,'fig',-3,2.25),"
              "(2,'apple',7,-0.5),(3,'zebra',1,4.0),(1,'pear',-2,3.0),"
              "(3,'apple',9,0.125),(2,'fig',4,0.0),(1,'kiwi',6,-1.0)")
    js, ts = aquery2_tpu.connect(), aquery2_tpu_torch.connect(device="cpu")
    js.execute(script)
    ts.execute(script)
    jr, tr = js.execute(sql), ts.execute(sql)
    assert tr.column_names() == jr.column_names()
    assert tr.rows() == jr.rows()


@pytest.mark.parametrize("keys", ["a", "a, b"])
def test_median_of_zeros_and_nan_matches_jax(keys):
    """-0.0 ties with 0.0 and NaN sorts last in the median's order, through
    the packed one-word sort ("a") and the two-sort order of a two-word
    key ("a, b": b spans 30 bits)."""
    a = np.array([1, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5, 5], np.int32)
    b = np.where(a == 5, 1 << 29, 0).astype(np.int32)
    c = np.array([-0.0, 0.0, 0.0, -0.0, 1.0, np.nan, -2.0, np.nan, np.nan,
                  -0.0, 2.5, -0.0], np.float32)
    ref = JTable("m", [JColumn("a", JT.IntT, a), JColumn("b", JT.IntT, b),
                       JColumn("c", JT.FloatT, c)])
    js, ts = aquery2_tpu.connect(), aquery2_tpu_torch.connect(device="cpu")
    js.catalog.create(ref)
    ts.catalog.create(TTable.from_reference(ref, device="cpu"))
    sql = f"SELECT {keys}, median(c) AS m, count(*) AS n FROM m GROUP BY {keys}"
    jr, tr = js.execute(sql), ts.execute(sql)
    assert tr.column_names() == jr.column_names()
    want = np.asarray(jr.table.columns["m"].data)[:jr.nrows]
    np.testing.assert_array_equal(tr.table.columns["m"].to_numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 1.0, np.nan, -0.0, 1.25])


class _CodeCasts(torch.overrides.TorchFunctionMode):
    """Counts the int64 tensors made from one tensor (its casts)."""

    def __init__(self, code):
        super().__init__()
        self.code, self.int64 = code, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (args and args[0] is self.code and isinstance(out, torch.Tensor)
                and out.dtype == torch.int64):
            self.int64 += 1
        return out


@pytest.mark.parametrize("extremes", [False, True])
def test_segment_reduce_sums_float64_lanes_with_the_add_lanes(extremes, rng):
    """segment_reduce's float64 lanes ride the add lanes' onehot_segment_sums
    calls (9 lanes: two calls): each within 1e-12 normwise of the sums
    index_add_ gave, min and max as scatter_reduce_ gives them, the add
    lanes exactly; an int64 copy of the codes is made only for min or
    max lanes."""
    n, domain = 5000, 10
    code = torch.from_numpy(rng.integers(0, domain + 1, n).astype(np.int32))
    add = {"__counts__": torch.from_numpy(rng.random(n) < 0.9),
           **{f"a{i}": torch.from_numpy(rng.integers(-9, 9, n))
              for i in range(5)}}
    f64 = {f"f{i}": torch.from_numpy(rng.normal(size=n) * 1e4)
           for i in range(3)}
    x = torch.from_numpy(rng.integers(-99, 99, n).astype(np.int32))
    mins, maxs = ({"mn": x}, {"mx": x}) if extremes else ({}, {})
    calls = []
    real = K.onehot_segment_sums
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "onehot_segment_sums",
                   lambda c, ls, dp: calls.append(len(ls)) or real(c, ls, dp))
        with _CodeCasts(code) as casts:
            outs = TR.segment_reduce(code, add, mins, maxs, f64, domain)
    assert calls == [8, 1]
    assert casts.int64 == (1 if extremes else 0)
    idx = code.to(torch.int64)
    for t, col in f64.items():
        old = torch.zeros(domain + 1, dtype=torch.float64).index_add_(
            0, idx, col)
        assert outs[t].dtype == torch.float64
        assert float((outs[t] - old).norm() / old.norm()) <= 1e-12, t
    for t, col in add.items():
        assert torch.equal(outs[t], torch.zeros(
            domain + 1, dtype=torch.int64).index_add_(0, idx, col.long()))
    if extremes:
        assert torch.equal(outs["mn"], torch.full(
            (domain + 1,), 2**31 - 1, dtype=torch.int32).scatter_reduce_(
                0, idx, x, "amin"))
        assert torch.equal(outs["mx"], torch.full(
            (domain + 1,), -2**31, dtype=torch.int32).scatter_reduce_(
                0, idx, x, "amax"))


# --- the dense tier's two forms of onehot_segment_sums ------------------------
# The form follows the plan: integer keys of one dtype, no min or max lane
# and no nullable argument take the keyed form (the kernel reads the
# columns as stored); a min or max lane or a nullable argument the code
# form. A float32 argument's limb lanes are made and passed as lanes, its
# slots still made in the kernel: the keyed form.
FORMS = {
    "q1": (QUERIES["q1"], "keyed"),
    "q2": (QUERIES["q2"], "keyed"),
    "q4": (QUERIES["q4"], "keyed"),
    "q9": (QUERIES["q9"], "keyed"),
    "where": ("SELECT id1, id2, sum(v1) AS s, avg(w) AS a, count(*) AS c "
              "FROM source WHERE v2 > 7 AND v3 < 60.5 GROUP BY id1, id2",
              "keyed"),
    "null_keys": ("SELECT k, sum(x) AS s, var(x) AS vr, count(*) AS c "
                  "FROM nk GROUP BY k", "keyed"),
    "min_max_beside_sum": ("SELECT id1, sum(v1) AS s, max(v2) AS mx, "
                           "min(v3) AS mn FROM source GROUP BY id1", "code"),
    "nullable_argument": ("SELECT g, sum(y) AS s, avg(y) AS a FROM nk "
                          "GROUP BY g", "code"),
    "float32_argument": ("SELECT id4, sum(v3) AS s, stddev(v3) AS sd "
                         "FROM source GROUP BY id4", "keyed"),
}


@pytest.fixture(scope="module")
def form_sessions(sessions):
    """sessions plus a table nk: k an int16 key with NULLs, x an int32,
    g an int64 key without NULLs, y an int32 with NULLs."""
    js, ts = sessions
    rng = np.random.default_rng(SEED + 2)
    n = 7000
    k = rng.integers(-3, 9, n).astype(np.int16)
    y = rng.integers(-99, 99, n).astype(np.int32)
    cols = [JColumn("k", JT.ShortT, k, valid=rng.random(n) < 0.9),
            JColumn("x", JT.IntT, rng.integers(-2**31, 2**31 - 1, n)
                    .astype(np.int32)),
            JColumn("g", JT.LongT, rng.integers(-20, 20, n)),
            JColumn("y", JT.IntT, y, valid=rng.random(n) < 0.8)]
    ref = JTable("nk", cols)
    js.catalog.create(ref)
    ts.catalog.create(TTable.from_reference(ref, device="cpu"))
    return js, ts


@pytest.mark.parametrize("name", list(FORMS))
def test_dense_tier_takes_the_form_its_plan_shows(name, form_sessions):
    """Each dense plan runs onehot_segment_sums in the form ONEHOT_FORMS
    records (keyed: q1 q2 q4 q9, a WHERE, NULL keys, a float32 argument;
    code: a min or max beside a sum, a nullable argument), and answers as
    the JAX package does."""
    js, ts = form_sessions
    sql, form = FORMS[name]
    table = "nk" if " FROM nk " in sql else "source"
    tsel, = tparse(sql)
    tt = ts.catalog.get(table)
    p = TF.plan(tsel, tt)
    coded = TF.sentinel_code_null_keys(p, tt)
    assert TF.choose_strategy(p, (coded[0] if coded else tt).columns)[0] \
        == "dense"
    before = dict(K.ONEHOT_FORMS)
    tr = ts.execute(sql)
    used = {f: K.ONEHOT_FORMS[f] - before[f] for f in before}
    assert used[form] > 0 and sum(used.values()) == used[form], used
    close = {**CLOSE.get(name, {}), "sd": SQRT_RTOL, "a": F64_SUM_RTOL,
             "vr": SQRT_RTOL}
    _assert_equal(js.execute(sql), tr, close, name)
