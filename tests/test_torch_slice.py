"""The h2o group-by slice through both packages: the JAX package
(aquery2_tpu.connect()) and the port (aquery2_tpu_torch.connect("cpu"))
get identical G1-shaped tables from one numpy seed and must return the
same column names, SQL types, row order and values.

Values are compared exactly, floats included: float sums are integer
limb sums in both packages (the add_float split), recombined by the same
float64 arithmetic, and averages divide by the same counts."""

import numpy as np
import pytest
import torch

import aquery2_tpu
from aquery2_tpu import types as JT
from aquery2_tpu.engine import fused_groupby as JF
from aquery2_tpu.parser import parse as jparse
from aquery2_tpu.storage.table import Column as JColumn, Table as JTable

import aquery2_tpu_torch
from aquery2_tpu_torch.engine import fused_groupby as TF
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.parser import parse as tparse
from aquery2_tpu_torch.storage.table import Table as TTable
from aquery2_tpu_torch.utils.datagen import H2O_COLUMNS, h2o_g1
from bench import QUERIES

N = 3 * 2 ** 14
SEED = 20240

CASES = {
    **{q: QUERIES[q] for q in ("q1", "q2", "q3", "q4", "q5", "q7", "q10")},
    "where": ("SELECT id6, sum(v1) AS v1, avg(v3) AS v3, count(*) AS c "
              "FROM source WHERE v2 > 7 AND v3 < 60.5 GROUP BY id6"),
    "having": ("SELECT id1, id2, sum(v1) AS v1, max(v3) AS mx FROM source "
               "GROUP BY id1, id2 HAVING avg(v3) > 50"),
    "having_packed": ("SELECT id3, min(v3) AS mn, sum(v2) AS v2 FROM source "
                      "GROUP BY id3 HAVING count(*) >= 11"),
}
TIERS = {"q1": "dense", "q2": "dense", "q4": "dense", "having": "dense",
         "q3": "packed", "q5": "packed", "q7": "packed", "q10": "packed",
         "where": "packed", "having_packed": "packed"}


@pytest.fixture(scope="module")
def data():
    return h2o_g1(N, 10, SEED)


@pytest.fixture(scope="module")
def sessions(data):
    js = aquery2_tpu.connect()
    ref = JTable("source", [
        JColumn(nm, JT.FloatT if nm == "v3" else JT.IntT, data[nm])
        for nm in H2O_COLUMNS])
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
    assert a.column_names() == b.column_names()
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

    jr, tr = js.execute(sql), ts.execute(sql)
    assert tr.column_names() == jr.column_names()
    assert tr.nrows == jr.nrows > 0
    for jc, tc in zip(jr.table.columns.values(), tr.table.columns.values()):
        assert tc.sqltype.name == jc.sqltype.name, tc.name
        jv = np.asarray(jc.data)[:jc.nrows]
        tv = tc.to_numpy()
        assert tv.dtype == jv.dtype, tc.name
        np.testing.assert_array_equal(tv, jv, err_msg=f"{name}.{tc.name}")
    assert tr.rows() == jr.rows()


def test_unported_shapes_raise(sessions):
    _js, ts = sessions
    for sql in ("SELECT id4, id5, median(v3) AS m FROM source GROUP BY id4, id5",
                "SELECT id2, id4, corr(v1, v2) AS r FROM source GROUP BY id2, id4",
                "SELECT id1, sum(v1) AS s FROM source GROUP BY id1 ORDER BY s",
                "SELECT id1 + id2, count(*) FROM source GROUP BY id1 + id2",
                "SELECT count(*) FROM source"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ts.execute(sql)


def test_packed_tier_on_cpu_launches_nothing(sessions):
    """CPU tensors take the kernels' plain versions: no launches."""
    _js, ts = sessions
    before = dict(K.LAUNCHES)
    ts.execute(CASES["q7"])
    assert K.LAUNCHES == before


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
