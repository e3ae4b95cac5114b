"""Attached SQL backends and external sources of the port
(storage/datasource.py, storage/external.py), each case held to the JAX
package on the same database: the cases of tests/test_datasource.py and
tests/test_storage.py::test_sqlite_attach. Tables read from a backend
land on the session's device, NULLs as validity, strings coded in the
order they first appear."""

import sqlite3

import pytest

import aquery2_tpu
from aquery2_tpu.storage.datasource import DataSourceError as JaxError
from aquery2_tpu.storage.external import attach_sqlite as jax_attach_sqlite
from aquery2_tpu.storage.external import from_dataframe as jax_from_df

import aquery2_tpu_torch
from aquery2_tpu_torch.storage.datasource import DataSourceError
from aquery2_tpu_torch.storage.external import attach_sqlite, from_dataframe


@pytest.fixture
def both(tmp_path):
    ts = aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path))
    js = aquery2_tpu.connect(base_dir=str(tmp_path))
    yield ts, js
    ts.close()
    js.close()


def _seed_sqlite(path):
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE trades(sym TEXT, price REAL, qty INTEGER)")
    conn.executemany("INSERT INTO trades VALUES (?,?,?)", [
        ("a", 10.0, 100), ("b", 20.0, 50), ("a", 12.0, 75),
        ("c", 5.0, None),
    ])
    conn.commit()
    conn.close()


def test_backend_exec_select(both, tmp_path):
    p = str(tmp_path / "x.db")
    _seed_sqlite(p)
    got = []
    for db in both:
        db.attach("ext", p)
        t = db.backend_exec(
            "ext", "SELECT sym, sum(qty) AS q FROM trades "
                   "WHERE qty IS NOT NULL GROUP BY sym ORDER BY sym",
            into="agg")
        r = db.execute("SELECT sym FROM agg WHERE q > 60 ORDER BY sym")
        got.append((t.nrows, [row[0] for row in r.rows()],
                    db.execute("SELECT sym, q FROM agg").rows()))
    assert got[0] == got[1] == (2, ["a"], [("a", 175), ("b", 50)])
    assert both[0].catalog.get("agg").columns["q"].device.type == "cpu"


def test_backend_exec_ddl_and_error(both):
    for db, err in zip(both, (DataSourceError, JaxError)):
        db.attach("m", ":memory:")
        src = db.sources["m"]
        assert db.backend_exec("m", "CREATE TABLE z(a INTEGER)") is None
        assert not src.haserror()
        with pytest.raises(err):
            db.backend_exec("m", "SELECT * FROM missing_table")
        assert src.haserror()
        db.backend_exec("m", "INSERT INTO z VALUES (1)")
        assert not src.haserror()


def test_get_table_maps_nulls(both, tmp_path):
    p = str(tmp_path / "y.db")
    _seed_sqlite(p)
    got = []
    for db in both:
        db.attach("ext", p)
        db.sources["ext"].get_table("trades", session=db)
        got.append((db.execute("SELECT sym FROM trades WHERE qty IS NULL")
                    .rows(), db.execute("SELECT sym, price, qty FROM trades")
                    .rows()))
    assert got[0] == got[1]
    assert got[0][0] == [("c",)]
    assert got[0][1][3] == ("c", 5.0, None)
    t = both[0].catalog.get("trades")
    assert t.columns["sym"].dictionary.strings() == ["a", "b", "c"]
    assert t.columns["qty"].valid is not None


def test_append_back_roundtrip(both, tmp_path):
    got = []
    for db, name in zip(both, ("t.db", "j.db")):
        p = str(tmp_path / name)
        db.attach("out", p)
        db.execute("CREATE TABLE res(k INT, v DOUBLE, s VARCHAR(4))")
        db.execute("INSERT INTO res VALUES (1, 1.5, 'x'), (2, 2.5, 'y')")
        db.backend_append("out", "res")
        conn = sqlite3.connect(p)
        rows = conn.execute("SELECT k, v, s FROM res ORDER BY k").fetchall()
        conn.close()
        db.backend_append("out", "res")         # appends, creates nothing
        conn = sqlite3.connect(p)
        n = conn.execute("SELECT count(*) FROM res").fetchone()[0]
        conn.close()
        got.append((rows, n))
    assert got[0] == got[1] == ([(1, 1.5, "x"), (2, 2.5, "y")], 4)


def test_engine_result_appends_back(both, tmp_path):
    got = []
    for db, name in zip(both, ("t.db", "j.db")):
        p = str(tmp_path / name)
        db.attach("out", p)
        db.execute("CREATE TABLE t(a INT, b INT)")
        db.execute("INSERT INTO t VALUES (1,2),(1,3),(2,5)")
        db.execute("SELECT a, sum(b) AS s FROM t GROUP BY a INTO gsum")
        db.backend_append("out", "gsum")
        conn = sqlite3.connect(p)
        got.append(sorted(conn.execute("SELECT a, s FROM gsum").fetchall()))
        conn.close()
    assert got[0] == got[1] == [(1, 5), (2, 5)]


def test_dbapi_source_wraps_any_connection(both):
    got = []
    for db in both:
        db.attach("raw", sqlite3.connect(":memory:"))
        db.backend_exec("raw", "CREATE TABLE q(a INTEGER)")
        db.backend_exec("raw", "INSERT INTO q VALUES (7)")
        t = db.backend_exec("raw", "SELECT a FROM q", into="qq")
        got.append((t.nrows, db.execute("SELECT a+1 FROM qq").scalar()))
    assert got[0] == got[1] == (1, 8)


def test_detach_closes(both):
    db = both[0]
    db.attach("m", ":memory:")
    src = db.sources["m"]
    db.detach("m")
    assert "m" not in db.sources
    with pytest.raises(sqlite3.ProgrammingError):
        src.conn.execute("SELECT 1")


def test_sqlite_attach(both, tmp_path):
    """attach_sqlite types the columns by their declarations; a DATE
    column (text in SQLite, which the JAX package cannot read) is held to
    the SQL answer."""
    conn = sqlite3.connect(tmp_path / "ext.db")
    conn.execute("CREATE TABLE trades(sym TEXT, px REAL, qty INTEGER)")
    conn.executemany("INSERT INTO trades VALUES (?,?,?)",
                     [("A", 1.5, 10), ("B", 2.5, None), ("A", 3.5, 30)])
    conn.execute("CREATE TABLE days(d DATE)")
    conn.executemany("INSERT INTO days VALUES (?)",
                     [("2020-01-02",), (None,), ("2021-03-04",)])
    conn.commit()
    conn.close()
    got = []
    for db, attach in zip(both, (attach_sqlite, jax_attach_sqlite)):
        names = attach(db, "ext.db", tables=["trades"])
        got.append((names, dict(db.execute(
            "SELECT sym, sum(qty) FROM trades GROUP BY sym").rows()),
            db.execute("SELECT sym, px, qty FROM trades").rows()))
    assert got[0] == got[1]
    assert got[0][:2] == (["trades"], {"A": 40, "B": 0})
    assert attach_sqlite(both[0], "ext.db") == ["trades", "days"]
    assert both[0].execute("SELECT d FROM days").rows() == \
        [("2020-01-02",), (None,), ("2021-03-04",)]


def test_from_dataframe():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"a": [1, 2], "b": ["x", "y"], "c": [0.5, 1.5]})
    got = []
    for db, ingest in ((aquery2_tpu_torch.connect(device="cpu"),
                        from_dataframe),
                       (aquery2_tpu.connect(), jax_from_df)):
        ingest(db, "pdt", df)
        got.append((db.execute("SELECT count(*) FROM pdt").scalar(),
                    db.execute("SELECT a, b, c FROM pdt").rows()))
        db.close()
    assert got[0] == got[1] == (2, [(1, "x", 0.5), (2, "y", 1.5)])
