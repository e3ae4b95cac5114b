"""LOAD MODULE in the port (sdk/modules.py): a C shared library built from
the port's own sdk/example_module.cpp and a Python module, each case
held to the JAX package on the same statements (the cases of
tests/test_sdk.py, and a module function over a filtered table, a
grouped table and pack())."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

import aquery2_tpu

import aquery2_tpu_torch

SDK_DIR = Path(aquery2_tpu_torch.__file__).resolve().parent / "sdk"


@pytest.fixture(scope="module")
def c_module(tmp_path_factory):
    out = tmp_path_factory.mktemp("mod") / "test_module.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-I", str(SDK_DIR),
                    "-o", str(out), str(SDK_DIR / "example_module.cpp")],
                   check=True)
    return str(out)


def both(tmp_path):
    return (aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path)),
            aquery2_tpu.connect(base_dir=str(tmp_path)))


def test_c_module_roundtrip(c_module, tmp_path):
    got = []
    for db in both(tmp_path):
        db.execute(f'''LOAD MODULE FROM "{c_module}" FUNCTIONS (
            mydiv(a:int, b:int) -> double,
            mulvec(a:int, b:vecfloat) -> vecfloat
        );''')
        db.execute("CREATE TABLE v(x real)")
        db.execute("INSERT INTO v VALUES (1.5), (2.5), (3.5)")
        got.append((db.execute("select mydiv(2,3);").scalar(),
                    [row[0] for row in db.execute(
                        "select mulvec(2, x) from v").rows()]))
        db.close()
    assert got[0] == got[1]
    assert got[0][0] == pytest.approx(2 / 3)
    np.testing.assert_allclose(got[0][1], [3.0, 5.0, 7.0])


def test_python_module(tmp_path):
    (tmp_path / "pymod.py").write_text(
        "import numpy as np\n"
        "def triple(x):\n"
        "    return np.asarray(x) * 3\n"
        "def scalar_add(a, b):\n"
        "    return float(a) + float(b)\n"
        "def rowsum(m):\n"
        "    return np.asarray(m).sum(axis=1)\n"
        "def init_session(session):\n"
        "    session.execute('CREATE TABLE made_by_init(a INT)')\n")
    got = []
    for db in both(tmp_path):
        db.execute('LOAD MODULE FROM "pymod.py" FUNCTIONS '
                   '(triple(x:vecint) -> vecint, scalar_add(a:double, '
                   'b:double) -> double, rowsum(m:vecvecdouble) -> '
                   'vecdouble);')
        db.execute("CREATE TABLE t(x int, y double)")
        db.execute("INSERT INTO t VALUES (1, 0.5), (2, 1.5), (3, 2.5)")
        got.append((
            [row[0] for row in db.execute("SELECT triple(x) FROM t").rows()],
            db.execute("SELECT scalar_add(1.5, 2)").scalar(),
            db.execute("SELECT rowsum(pack(x, y)) FROM t").rows(),
            db.execute("SELECT count(*) FROM made_by_init").scalar()))
        db.close()
    assert got[0] == got[1]
    assert got[0] == ([3, 6, 9], 3.5, [(1.5,), (3.5,), (5.5,)], 0)


def test_module_over_a_filtered_table(tmp_path):
    """The arguments are the rows the WHERE kept, in the working set's
    order."""
    (tmp_path / "m.py").write_text(
        "import numpy as np\n"
        "def neg(x):\n"
        "    return -np.asarray(x)\n")
    got = []
    for db in both(tmp_path):
        db.execute('LOAD MODULE FROM "m.py" FUNCTIONS (neg(x:vecint) -> '
                   'vecint)')
        db.execute("CREATE TABLE t(x int)")
        db.execute("INSERT INTO t VALUES (1), (5), (2), (7)")
        got.append(db.execute("SELECT neg(x) FROM t WHERE x > 1").rows())
        db.close()
    assert got[0] == got[1] == [(-5,), (-2,), (-7,)]


def test_module_over_a_vector_column(tmp_path):
    """A vecvec argument from a vector column of equal-length rows comes
    as one [n, k] matrix, and a ragged one as a list of arrays."""
    (tmp_path / "m.py").write_text(
        "import numpy as np\n"
        "def width(m):\n"
        "    return float(sum(len(r) for r in m))\n"
        "def first(m):\n"
        "    return np.asarray([r[0] for r in m])\n")
    (tmp_path / "v.csv").write_text("1;2;3,1\n4;5;6,2\n")
    (tmp_path / "r.csv").write_text("1;2,1\n4;5;6,2\n")
    got = []
    for db in both(tmp_path):
        db.execute('LOAD MODULE FROM "m.py" FUNCTIONS (width(m:vecvecdouble)'
                   ' -> double, first(m:vecvecdouble) -> vecdouble)')
        out = []
        for name in ("v", "r"):
            db.execute(f"CREATE TABLE {name}(x vecdouble, y int)")
            db.execute(f'LOAD COMPLEX DATA INFILE "{name}.csv" INTO TABLE '
                       f"{name} FIELDS TERMINATED BY ',' ELEMENT TERMINATED "
                       "BY ';'")
            out.append((db.execute(f"SELECT width(x) FROM {name}").scalar(),
                        db.execute(f"SELECT first(x) FROM {name}").rows()))
        got.append(out)
        db.close()
    assert got[0] == got[1] == [(6.0, [(1.0,), (4.0,)]),
                                (5.0, [(1.0,), (4.0,)])]
    # under WHERE the port passes the kept rows; the JAX package passes
    # the whole column (ROADMAP queue 3), so this is held to SQL
    db = aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path))
    db.execute('LOAD MODULE FROM "m.py" FUNCTIONS (width(m:vecvecdouble) '
               '-> double, first(m:vecvecdouble) -> vecdouble)')
    db.execute("CREATE TABLE r(x vecdouble, y int)")
    db.execute("LOAD COMPLEX DATA INFILE \"r.csv\" INTO TABLE r FIELDS "
               "TERMINATED BY ',' ELEMENT TERMINATED BY ';'")
    assert db.execute("SELECT width(x) FROM r WHERE y = 2").scalar() == 3.0
    assert db.execute("SELECT first(x) FROM r WHERE y = 2").rows() == \
        [(4.0,)]
    db.close()
