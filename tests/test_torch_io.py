"""Data in and out of the port: CSV LOAD, INTO OUTFILE, Result exports,
the session surface (base_dir, run_script, the context manager) and the
query stats, against the JAX package (aquery2_tpu.connect()) on the same
files, which each test writes under tmp_path.

Both of the port's CSV routes (np.loadtxt, typed or, where a cell is
empty, through strings; and the line reader that takes LOAD COMPLEX
DATA and vector columns) are held to the JAX package's table."""

import pytest

import aquery2_tpu
from aquery2_tpu.engine import udf_rewrite as jax_udf_rewrite

import aquery2_tpu_torch
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import udf_rewrite
from aquery2_tpu_torch.storage import csvio
from aquery2_tpu_torch.storage.result import Result
from aquery2_tpu_torch.storage.table import Column, Table, VectorColumn

CLIPSUM = """AGGREGATION FUNCTION clipsum(x, c){ s := 0.; l := _builtin_len;
    for (i := 0; i < l; i += 1) { if (x[i] > c) { s += c; }
    else { s += x[i]; } } s }"""


def _both(tmp_path):
    return (aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path)),
            aquery2_tpu.connect(base_dir=str(tmp_path)))


# --- the cases of tests/test_storage.py ----------------------------------------

def test_result_format_and_csv(tmp_path):
    t = Table("r", [
        Column.from_host("a", T.IntT, [1, 2], device="cpu"),
        Column.from_host("b", T.DoubleT, [1.5, 2.5], device="cpu"),
    ])
    r = Result(t)
    s = r.format()
    assert "a" in s and "1.5" in s
    p = tmp_path / "out.csv"
    r.to_csv(str(p), sep=";")
    content = p.read_text().strip().splitlines()
    assert content[0] == "a;b"
    assert content[1] == "1;1.5"


def test_result_vector_csv(tmp_path):
    t = Table("r", [VectorColumn.from_lists("v", T.VecIntT, [[1, 2], [3]],
                                            device="cpu")])
    p = tmp_path / "v.csv"
    Result(t).to_csv(str(p))
    lines = p.read_text().strip().splitlines()
    assert lines[1] == "1;2"
    assert lines[2] == "3"


def test_result_to_pandas_matches_jax():
    pd = pytest.importorskip("pandas")
    got = []
    for db in (aquery2_tpu_torch.connect(device="cpu"), aquery2_tpu.connect()):
        db.execute("CREATE TABLE t(a INT, s VARCHAR(4))")
        db.execute("INSERT INTO t VALUES (1, 'x'), (NULL, 'y'), (3, 'x')")
        got.append(db.execute("SELECT a, s FROM t").to_pandas())
    assert isinstance(got[0], pd.DataFrame)
    pd.testing.assert_frame_equal(got[0], got[1])


# --- LOAD: the cases of tests/test_dates.py and tests/test_nulls.py -------------

def test_csv_date_roundtrip(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("sym,d,price\nX,2024-02-29,7\nY,2024-03-01,9\n")
    for db in _both(tmp_path):
        db.execute("CREATE TABLE dd(sym VARCHAR(4), d DATE, price INT)")
        db.execute(f'LOAD DATA INFILE "{p}" INTO TABLE dd '
                   f'FIELDS TERMINATED BY ","')
        r = db.execute("SELECT sym FROM dd WHERE d = '2024-02-29'")
        assert r.rows() == [("X",)]
        r2 = db.execute("SELECT d FROM dd ORDER BY d")
        assert [x for (x,) in r2.rows()] == ["2024-02-29", "2024-03-01"]


def test_csv_empty_cells_load_as_null(tmp_path):
    p = tmp_path / "nulls.csv"
    p.write_text("a,b\n1,\n,2\n3,4\n")
    for db in _both(tmp_path):
        db.execute("CREATE TABLE c(a INT, b INT)")
        db.execute(f'LOAD DATA INFILE "{p}" INTO TABLE c '
                   f'FIELDS TERMINATED BY ","')
        r = db.execute("SELECT a, b FROM c")
        assert r.rows() == [(1, None), (None, 2), (3, 4)]
        r = db.execute("SELECT count(a), count(b), count(*) FROM c")
        assert r.rows()[0] == (2, 2, 3)


# --- both routes against the JAX package's table ------------------------------

MIXED = ("CREATE TABLE m(s VARCHAR(8), i INT, f DOUBLE, b BOOLEAN, "
         "d DATE, ts TIMESTAMP)")
MIXED_ROWS = ["zz,1,1.5,true,2024-01-02,2024-01-02 10:00:00",
              " aa ,-2, 2.25 ,0,2023-12-31,2023-12-31 23:59:59.5",
              "zz,3,-0.5,yes,2024-01-02,2024-01-03 00:00:00",
              "b,4,1e3,false,,2024-01-04 12:30:00",
              ",5,7,t,2024-02-29,"]


@pytest.mark.parametrize("complex_load", [False, True])
@pytest.mark.parametrize("header", [True, False])
@pytest.mark.parametrize("empty_number", [False, True])
def test_load_matches_jax(tmp_path, header, empty_number, complex_load):
    """A header line is skipped because it does not parse; a first data
    line that parses is kept. An empty numeric cell makes loadtxt read
    the numeric columns as strings; LOAD COMPLEX DATA takes the line
    reader; the table is the JAX package's on every route (strings in
    first-seen dictionary order, trimmed; empty string cells "", other
    empty cells NULL; bools, dates and timestamps parsed)."""
    rows = list(MIXED_ROWS)
    if empty_number:
        rows[2] = "zz,,-0.5,yes,2024-01-02,2024-01-03 00:00:00"
    text = ("s,i,f,b,d,ts\n" if header else "") + "\n".join(rows) + "\n"
    (tmp_path / "m.csv").write_text(text)
    tables = []
    for db in _both(tmp_path):
        db.execute(MIXED)
        kw = "COMPLEX " if complex_load else ""
        db.execute(f'LOAD {kw}DATA INFILE "m.csv" INTO TABLE m '
                   'FIELDS TERMINATED BY ","')
        tables.append(db)
    q = "SELECT s, i, f, b, d, ts FROM m"
    got, want = (db.execute(q).rows() for db in tables)
    assert got == want
    assert len(got) == 5 and got[1][0] == "aa" and got[4][0] == ""
    assert got[3][4] is None and got[4][5] is None
    assert (got[2][1] is None) == empty_number
    q = "SELECT s, count(*) AS c FROM m GROUP BY s"
    assert tables[0].execute(q).rows() == tables[1].execute(q).rows()
    t = tables[0].catalog.get("m")
    assert t.columns["s"].dictionary.strings() == \
        tables[1].catalog.get("m").columns["s"].dictionary.strings()


def test_loadtxt_route_taken(tmp_path, monkeypatch):
    """A plain file into an all-numeric table takes the C++ scanner, with
    or without an empty cell; into a table with a VARCHAR column,
    np.loadtxt, with or without an empty numeric cell; LOAD COMPLEX DATA
    always the line reader."""
    routes = []
    for name in ("_load_native", "_load_numpy", "_load_python"):
        orig = getattr(csvio, name)

        def spy(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            routes.append((_name, out))
            return out
        monkeypatch.setattr(csvio, name, spy)
    (tmp_path / "a.csv").write_text("1,2\n3,4\n")
    (tmp_path / "b.csv").write_text("1,2\n,4\n")
    (tmp_path / "c.csv").write_text("1,x\n3,y\n")
    (tmp_path / "d.csv").write_text("1,x\n,y\n")
    db = aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path))
    db.execute("CREATE TABLE t(a INT, b INT)")
    db.execute('LOAD DATA INFILE "a.csv" INTO TABLE t')
    assert routes == [("_load_native", 2)]
    db.execute('LOAD DATA INFILE "b.csv" INTO TABLE t')
    assert routes[1:] == [("_load_native", 2)]
    db.execute('LOAD COMPLEX DATA INFILE "a.csv" INTO TABLE t')
    assert routes[2:] == [("_load_python", 2)]
    assert db.execute("SELECT a, b FROM t").rows() == [
        (1, 2), (3, 4), (1, 2), (None, 4), (1, 2), (3, 4)]
    db.execute("CREATE TABLE s(a INT, b VARCHAR(4))")
    db.execute('LOAD DATA INFILE "c.csv" INTO TABLE s')
    db.execute('LOAD DATA INFILE "d.csv" INTO TABLE s')
    assert routes[3:] == [("_load_numpy", 2), ("_load_numpy", 2)]
    assert db.execute("SELECT a, b FROM s").rows() == [
        (1, "x"), (3, "y"), (1, "x"), (None, "y")]


@pytest.mark.parametrize("text,sep,empty", [
    ("1,2\n3,4\n", ",", False), ("1,2\n3,4", ",", False),
    ("1,2\n,4\n", ",", True), (",2\n", ",", True), ("1,\n", ",", True),
    ("1,2\n3,", ",", True), ("1, ,2\n", ",", True),
    ("1,2\r\n3, \r\n", ",", True), ("1,2\r\n3,4\r\n", ",", False),
    ("a\tb\n\t\n", "\t", True), ("a b\n1 2\n", " ", False),
    ("1|2\n\n3|4\n", "|", False)])
def test_empty_cell_scan(tmp_path, text, sep, empty):
    """The byte scan that chooses loadtxt's typed or string read finds
    exactly the files with an empty or blank field (a blank line is not
    one: both readers skip it)."""
    p = tmp_path / "s.csv"
    p.write_bytes(text.encode())
    assert csvio._has_empty_cell(str(p), sep) == empty


def test_blank_cells_and_crlf_load_as_null(tmp_path):
    """A cell of blanks is NULL, as an empty one is, under CRLF line
    ends; the JAX package's table."""
    (tmp_path / "w.csv").write_bytes(b"a,b\r\n1, \r\n  ,2.5\r\n3,4\r\n")
    got = []
    for db in _both(tmp_path):
        db.execute("CREATE TABLE w(a INT, b DOUBLE)")
        db.execute('LOAD DATA INFILE "w.csv" INTO TABLE w')
        got.append(db.execute("SELECT a, b FROM w").rows())
    assert got[0] == got[1] == [(1, None), (None, 2.5), (3, 4.0)]


def test_load_complex_vector_cells(tmp_path):
    """LOAD COMPLEX DATA: vector cells split by the element separator,
    with and without a header."""
    for i, head in enumerate(("id|xs|name\n", "")):
        (tmp_path / f"v{i}.csv").write_text(
            head + "1|1;2;3|a\n2||b\n3|4;;5|a\n")
        out = []
        for db in _both(tmp_path):
            db.execute("CREATE TABLE v(id INT, xs VECINT, name VARCHAR(4))")
            db.execute(f'LOAD COMPLEX DATA INFILE "v{i}.csv" INTO TABLE v '
                       f'FIELDS TERMINATED BY "|" ELEMENT TERMINATED BY ";"')
            out.append(db.execute("SELECT * FROM v").rows())
        assert out[0] == out[1] == [(1, [1, 2, 3], "a"), (2, [], "b"),
                                    (3, [4, 5], "a")]


def test_base_dir_resolves_relative_paths(tmp_path):
    sub = tmp_path / "data"
    sub.mkdir()
    (sub / "t.csv").write_text("k,v\n1,10\n2,20\n1,30\n")
    db = aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path))
    assert db.base_dir == str(tmp_path)
    assert db.resolve_path("data/t.csv") == str(sub / "t.csv")
    assert db.resolve_path(str(sub / "t.csv")) == str(sub / "t.csv")
    db.execute("CREATE TABLE t(k INT, v INT)")
    db.execute('LOAD DATA INFILE "data/t.csv" INTO TABLE t')
    db.execute('SELECT k, sum(v) AS s FROM t GROUP BY k '
               'INTO OUTFILE "data/o.csv" FIELDS TERMINATED BY ";"')
    assert (sub / "o.csv").read_text() == "1;40\n2;20\n"


# --- INTO OUTFILE on every route ------------------------------------------------

OUTFILE_QUERIES = {
    # (query, route of the port's fused tiers)
    "fused_groupby": "SELECT k, sum(v) AS s, avg(w) AS a FROM t GROUP BY k",
    "general": ("SELECT k, sum(v) AS s FROM t WHERE w > 1.5 GROUP BY k "
                "ORDER BY s DESC"),
    "fused_scan": "SELECT k, v FROM t WHERE v > 15 ORDER BY v",
    # the JAX package's fused UDF tier, the port's traced route
    "fused_udf": "SELECT k, clipsum(v, 25) AS c FROM t GROUP BY k",
    "vector": "SELECT k, v FROM t ASSUMING ASC v GROUP BY k",
}


@pytest.mark.parametrize("name", sorted(OUTFILE_QUERIES))
def test_into_outfile_matches_jax(tmp_path, name, monkeypatch):
    """INTO OUTFILE writes the result without a header, on every route,
    byte for byte as the JAX package does; a vector cell's elements are
    joined by ';'."""
    monkeypatch.setattr(udf_rewrite, "rewrite_select",
                        lambda session, sel: None)
    monkeypatch.setattr(jax_udf_rewrite, "rewrite_select",
                        lambda session, sel: None)
    q = OUTFILE_QUERIES[name]
    texts = []
    for tag, db in zip("tj", _both(tmp_path)):
        db.execute(CLIPSUM)
        db.execute("CREATE TABLE t(k INT, v INT, w DOUBLE)")
        db.execute("INSERT INTO t VALUES (1, 10, 1.25), (2, 20, 2.5), "
                   "(1, 30, 0.75), (3, 40, 3.0), (2, 5, 1.5)")
        db.execute(f'{q} INTO OUTFILE "{tag}.csv" FIELDS TERMINATED BY ","')
        texts.append((tmp_path / f"{tag}.csv").read_text())
        assert db.execute(q).nrows == len(texts[-1].splitlines())
        if name == "fused_udf":
            assert db.stats.udf_paths == {"traced" if tag == "t"
                                          else "fused": 2}
    assert texts[0] == texts[1]
    assert not texts[0].startswith("k,")


def test_into_outfile_and_table(tmp_path):
    db = aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path))
    db.execute(CLIPSUM)
    db.execute("CREATE TABLE t(k INT, v INT)")
    db.execute("INSERT INTO t VALUES (1, 10), (2, 20), (1, 30)")
    db.execute('SELECT k, clipsum(v, 15) AS c FROM t GROUP BY k INTO r')
    assert db.execute("SELECT k, c FROM r").rows() == [(1, 25.0), (2, 15.0)]
    assert db.stats.udf_paths == {"traced": 1}


# --- the session surface and stats ---------------------------------------------

def test_run_script_and_context_manager(tmp_path):
    from aquery2_tpu_torch.parser import parse

    with aquery2_tpu_torch.connect(device="cpu",
                                   base_dir=str(tmp_path)) as db:
        r = db.run_script(parse("CREATE TABLE t(a INT); "
                                "INSERT INTO t VALUES (1), (2), (3); "
                                "SELECT sum(a) AS s FROM t"))
        assert r.rows() == [(6,)]
        assert db.stats.queries == 0           # run_script is not timed
    db.close()                                  # nothing to release


def test_stats_after_queries(capsys):
    db = aquery2_tpu_torch.connect(device="cpu")
    db.execute(CLIPSUM)
    db.execute("CREATE TABLE t(k INT, v INT); INSERT INTO t VALUES (1, 2), "
               "(1, 30), (2, 4)")
    db.execute("SELECT k, clipsum(v, 10) AS c FROM t GROUP BY k")
    db.execute("SELECT clipsum(v, 10) AS c FROM t")
    st = db.stats
    assert st.queries == 4 and len(st.history) == 4
    assert st.parse_time > 0 and st.exec_time > 0
    assert st.udf_paths == {"traced": 2}
    text = st.format()
    assert "Queries executed: 4" in text
    assert "UDF paths:        traced=2" in text
    assert "SELECT clipsum(v, 10) AS c FROM t" in text
    st.reset()
    assert st.queries == 0 and not st.history and not st.udf_paths
    db.log("hello")
    db.log_error("bad")
    db.log_level = "silent"
    db.log("quiet")
    db.log_error("quiet")
    assert capsys.readouterr().out == "hello\nerror: bad\n"


# --- Table.ncols, schema(), head() and the sample CSV writers ---------------

def test_table_ncols_schema_head_match_jax():
    """The same table in both packages: its column count, its (name, SQL
    type) schema and its head of k rows as text."""
    script = ("CREATE TABLE h(a INT, s VARCHAR(6), f DOUBLE, d DATE, b BIGINT);"
              "INSERT INTO h VALUES (3, 'pear', 1.5, '2003-01-02', NULL), "
              "(1, 'fig', -0.25, '2003-02-11', 7), "
              "(2, 'apple', 1e10, '2004-12-31', -5)")
    ts, js = aquery2_tpu_torch.connect(device="cpu"), aquery2_tpu.connect()
    for db in (ts, js):
        db.execute(script)
        db.execute("INSERT INTO h SELECT a + 10, s, f * 2, d, b FROM h")
    t, j = ts.catalog.get("h"), js.catalog.get("h")
    assert t.ncols == j.ncols == 5
    assert [(nm, st.name) for nm, st in t.schema()] == \
        [(nm, st.name) for nm, st in j.schema()]
    for k in (0, 2, 6, 10):
        assert t.head(k) == j.head(k), k
    assert t.head() == j.head()


@pytest.mark.parametrize("writer,kwargs", [
    ("stock_csv", {}), ("stock_csv", {"n_days": 7, "n_symbols": 2,
                                      "seed": 11}),
    ("base_csv", {}), ("base_csv", {"n_symbols": 6, "seed": 1}),
    ("tick_hist_csv", {}), ("tick_hist_csv", {"n_symbols": 2, "n_days": 30,
                                              "seed": 4}),
])
def test_sample_csv_writers_match_jax(tmp_path, writer, kwargs):
    """The port's own copies of the JAX package's CSV writers write the
    same bytes from the same seed."""
    from aquery2_tpu.utils import datagen as jgen

    from aquery2_tpu_torch.utils import datagen as tgen

    paths = {}
    for tag, mod in (("t", tgen), ("j", jgen)):
        names = [tmp_path / f"{tag}_{i}.csv" for i in range(2)]
        if writer == "tick_hist_csv":
            getattr(mod, writer)(str(names[0]), str(names[1]), **kwargs)
        else:
            getattr(mod, writer)(str(names[0]), **kwargs)
            names = names[:1]
        paths[tag] = names
    for pt, pj in zip(paths["t"], paths["j"]):
        assert pt.read_bytes() == pj.read_bytes()
        assert pt.stat().st_size > 0
