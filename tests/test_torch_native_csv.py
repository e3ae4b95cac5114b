"""The port's C++ CSV scanner (native/csvscan.cpp), the route of a plain
LOAD DATA INFILE into an all-numeric table, against the JAX package's
own scanner (aquery2_tpu/native, built here with g++) on the same files:
blank cells and cells of spaces, CRLF line ends, a last line without a
newline, the header rule, int64 and float32 columns, and a file of more
than 65,536 rows, which the scanner splits across threads.

Where the JAX scanner breaks SQL (a float in an INT column read as its
integer part, an int32 overflow wrapped, nan and inf read as 0, a blank
line loaded as a row of NULLs) the case is held to numpy (nan, inf,
blank lines, the nearest double of a decimal) or to the line reader's
parse (Python's int, then the column's type) instead. A failed build and
a cell that does not parse raise."""

import numpy as np
import pytest

import aquery2_tpu
from aquery2_tpu.storage import csvio as jax_csvio

import aquery2_tpu_torch
from aquery2_tpu_torch import native
from aquery2_tpu_torch.storage import csvio

SCHEMA = "a INT, b DOUBLE"


@pytest.fixture
def routes(monkeypatch):
    """The routes each package took: the port's by route(), the JAX
    package's native one when its _load_native answered."""
    seen = []
    orig = jax_csvio._load_native

    def jax_native(*a, **k):
        n = orig(*a, **k)
        seen.append(("jax", n is not None))
        return n
    monkeypatch.setattr(jax_csvio, "_load_native", jax_native)
    port_route = csvio.route

    def spy(*a, **k):
        r = port_route(*a, **k)
        seen.append(("port", r))
        return r
    monkeypatch.setattr(csvio, "route", spy)
    return seen


def load_both(tmp_path, text: bytes, schema=SCHEMA, cols="a, b"):
    (tmp_path / "f.csv").write_bytes(text)
    out = []
    for db in (aquery2_tpu_torch.connect(device="cpu",
                                         base_dir=str(tmp_path)),
               aquery2_tpu.connect(base_dir=str(tmp_path))):
        db.execute(f"CREATE TABLE t({schema})")
        db.execute('LOAD DATA INFILE "f.csv" INTO TABLE t')
        out.append(db.execute(f"SELECT {cols} FROM t").rows())
        db.close()
    return out


def load_port(tmp_path, text: bytes, schema=SCHEMA, cols="a, b"):
    (tmp_path / "f.csv").write_bytes(text)
    db = aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path))
    db.execute(f"CREATE TABLE t({schema})")
    db.execute('LOAD DATA INFILE "f.csv" INTO TABLE t')
    return db.execute(f"SELECT {cols} FROM t").rows()


@pytest.mark.parametrize("text,want", [
    (b"a,b\n1,2.5\n3,4\n", [(1, 2.5), (3, 4.0)]),                  # header
    (b"1,2.5\n3,4\n", [(1, 2.5), (3, 4.0)]),                      # none
    (b"1,2.5\n3,4", [(1, 2.5), (3, 4.0)]),                  # no last newline
    (b"a,b\r\n1,2.5\r\n3,4\r\n", [(1, 2.5), (3, 4.0)]),              # CRLF
    (b"a,b\n1,\n,2.5\n", [(1, None), (None, 2.5)]),            # empty cells
    (b"a,b\n1,  \n \t,2.5\n", [(1, None), (None, 2.5)]),       # blank cells
    (b"a,b\r\n1, \r\n  ,2.5\r\n3,4\r\n", [(1, None), (None, 2.5), (3, 4.0)]),
    (b"a,b\n -7 , +2e3 \n+8,-.5\n", [(-7, 2000.0), (8, -0.5)]),
    (b"a,b\n2147483647,1e308\n-2147483648,-0.0\n",
     [(2147483647, 1e308), (-2147483648, -0.0)]),
    (b"x,1.5\n1,2\n", [(1, 2.0)]),        # a first line that does not parse
])
def test_scanner_matches_jax_scanner(tmp_path, routes, text, want):
    got = load_both(tmp_path, text)
    assert routes == [("port", "native"), ("jax", True)]
    assert got[0] == got[1] == want


def test_int64_float32_columns_match_jax(tmp_path, routes):
    rng = np.random.default_rng(3)
    a = rng.integers(-2**62, 2**62, 500)
    b = rng.normal(0, 1e3, 500).astype(np.float32)
    text = "".join(f"{x},{y!r}\n" for x, y in zip(a.tolist(),
                                                 b.tolist())).encode()
    got = load_both(tmp_path, text, "a BIGINT, b REAL")
    assert got[0] == got[1]
    assert [r[0] for r in got[0]] == a.tolist()
    np.testing.assert_array_equal(np.asarray([r[1] for r in got[0]],
                                             np.float32), b)


def test_threaded_split_matches_jax(tmp_path, routes):
    """100,003 rows (the scanner runs in up to 16 threads above 65,536),
    with empty cells, CRLF on some lines and no last newline."""
    rng = np.random.default_rng(7)
    n = 100_003
    a = rng.integers(-1000, 1000, n)
    b = np.round(rng.uniform(-50, 50, n), 3)
    lines = [f"{x},{y}" for x, y in zip(a.tolist(), b.tolist())]
    for i in rng.choice(n, 300, replace=False):
        lines[i] = "," + lines[i].split(",")[1] if i % 2 else \
            lines[i].split(",")[0] + ", "
    for i in rng.choice(n, 300, replace=False):
        lines[i] += "\r"
    text = ("a,b\n" + "\n".join(lines)).encode()
    got = load_both(tmp_path, text)
    assert len(got[0]) == len(got[1]) == n
    assert [r[0] for r in got[0]] == [r[0] for r in got[1]]
    assert [r[1] is None for r in got[0]] == [r[1] is None for r in got[1]]
    # floats as numpy parses the text (the JAX scanner sums digits and
    # may miss the nearest double by an ulp)
    want = [None if not ln.split(",")[1].strip() else
            float(ln.split(",")[1]) for ln in lines]
    assert [r[1] for r in got[0]] == want
    np.testing.assert_allclose(
        [r[1] for r in got[0] if r[1] is not None],
        [r[1] for r in got[1] if r[1] is not None], rtol=1e-15)
    keep = [i for i, ln in enumerate(lines) if not ln.startswith(",")]
    assert [got[0][i][0] for i in keep] == a[keep].tolist()
    assert sum(r[0] is None for r in got[0]) == \
        sum(ln.startswith(",") for ln in lines) > 100


@pytest.mark.parametrize("cell", ["1.5", "3000000000", "1e5", "abc"])
def test_cells_jax_misreads_raise(tmp_path, cell):
    """The JAX scanner truncates or wraps these (1.5 as 1, 3000000000 as
    -1294967296); the line reader's parse (Python's int, then the
    column's int32) refuses them, and so do the port's scanner and its
    loadtxt route (a VARCHAR column beside)."""
    with pytest.raises((ValueError, OverflowError)):
        np.int32(int(cell))
    with pytest.raises(ValueError, match="column 1"):
        load_port(tmp_path, f"a,b\n1,2\n{cell},2\n".encode())
    with pytest.raises(ValueError):
        load_port(tmp_path, f"a,b\n1,x\n{cell},y\n".encode(),
                  "a INT, b VARCHAR(4)")


def test_int64_overflow_raises(tmp_path):
    with pytest.raises(ValueError, match="column 1"):
        load_port(tmp_path, b"a,b\n9223372036854775808,1\n",
                  "a BIGINT, b DOUBLE")
    assert load_port(tmp_path, b"a,b\n-9223372036854775808,1\n",
                     "a BIGINT, b DOUBLE") == [(-2**63, 1.0)]


def test_nan_and_inf_follow_numpy(tmp_path):
    text = b"a,b\n1,nan\n2,inf\n3,-Infinity\n4,NaN\n5,+INF\n6,1e400\n"
    want = np.loadtxt(text.decode().splitlines()[1:], delimiter=",",
                      dtype=np.float64)[:, 1]
    got = np.asarray([r[1] for r in load_port(tmp_path, text)])
    np.testing.assert_array_equal(got, want)


def test_blank_lines_are_skipped_as_numpy_does(tmp_path):
    text = b"a,b\n1,2\n\n3,4\n \t\r\n5,6\n"
    want = np.loadtxt([ln for ln in text.decode().splitlines()[1:]
                       if ln.strip()], delimiter=",")
    assert load_port(tmp_path, text) == [tuple(r) for r in want.tolist()]


@pytest.mark.parametrize("text", [b"a,b\n1,2,3\n", b"a,b\n1\n",
                                  b"a,b\n1,2\n3;4\n"])
def test_field_count_mismatch_raises(tmp_path, text):
    with pytest.raises(ValueError):
        load_port(tmp_path, text)


def test_routes_follow_the_schema(tmp_path, routes):
    """All-numeric plain loads take the scanner; a VARCHAR, DATE, BOOLEAN
    or SMALLINT column, or LOAD COMPLEX DATA, does not."""
    (tmp_path / "n.csv").write_text("1,2\n")
    db = aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path))
    for schema in ("a INT, b BIGINT", "a REAL, b DOUBLE", "a INT, b VARCHAR(4)",
                   "a INT, b DATE", "a INT, b BOOLEAN", "a INT, b SMALLINT"):
        db.execute(f"CREATE TABLE t({schema})")
        assert csvio.route(db.catalog.get("t")) == (
            "native" if "BIGINT" in schema or "REAL" in schema
            else "loadtxt")
        db.execute("DROP TABLE t")
    db.execute("CREATE TABLE t(a INT, b INT)")
    t = db.catalog.get("t")
    assert csvio.route(t, complex_cells=True) == "lines"
    assert csvio.route(t, field_sep="||") == "lines"


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "csvscan.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.build.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed(.|\n)*error"):
            native.build()
        (tmp_path / "f.csv").write_text("1,2\n")
        with pytest.raises(RuntimeError, match="build failed"):
            native.parse_numeric_csv(str(tmp_path / "f.csv"),
                                     [np.int32, np.int32], ",", False)
    finally:
        native.build.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_is_named_by_its_source():
    so = native.library_path()
    assert so.parent == native.BUILD_DIR and so.name.startswith("libaqcsv_")
    assert native.library_path() == so
