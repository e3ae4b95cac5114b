"""The port's model library (models/: decision tree, incremental random
forest, the irf module) and LOAD MODULE of it, held to the JAX package's
models with the same seeds: the same trees, predictions and accuracies
(the cases of tests/test_models.py), then the demo's stream
(aquery2_tpu_torch/demo.py) through both packages with the same batches,
giving the same accuracy after each batch."""

import os
from pathlib import Path

import numpy as np
import pytest

import aquery2_tpu
from aquery2_tpu.models import DecisionTree as JaxTree
from aquery2_tpu.models import IncrementalRandomForest as JaxForest
from aquery2_tpu.utils.datagen import electricity_csv as jax_electricity

import aquery2_tpu_torch
from aquery2_tpu_torch import demo
from aquery2_tpu_torch.models import DecisionTree, IncrementalRandomForest
from aquery2_tpu_torch.utils.datagen import electricity_csv

REPO = Path(__file__).resolve().parents[1]
PORT_IRF = str(REPO / "aquery2_tpu_torch" / "models" / "irf.py")
JAX_IRF = str(REPO / "aquery2_tpu" / "models" / "irf.py")


def _blob_data(rng, n=400):
    """Two separable gaussian blobs."""
    X0 = rng.normal(0.0, 1.0, (n // 2, 4))
    X1 = rng.normal(3.0, 1.0, (n // 2, 4))
    X = np.concatenate([X0, X1])
    y = np.concatenate([np.zeros(n // 2, np.int64), np.ones(n // 2, np.int64)])
    idx = rng.permutation(n)
    return X[idx], y[idx]


def _nodes(node):
    """A tree as nested tuples (feature, threshold, prediction, ...)."""
    if node is None:
        return None
    return (node.feature, node.threshold, node.prediction,
            _nodes(node.left), _nodes(node.right))


def test_decision_tree(rng):
    X, y = _blob_data(rng)
    mine = DecisionTree(max_depth=6, feature_subset=2,
                        rng=np.random.default_rng(5)).fit(X, y)
    theirs = JaxTree(max_depth=6, feature_subset=2,
                     rng=np.random.default_rng(5)).fit(X, y)
    assert _nodes(mine.root) == _nodes(theirs.root)
    np.testing.assert_array_equal(mine.predict(X), theirs.predict(X))
    assert (mine.predict(X) == y).mean() > 0.95


def test_incremental_forest(rng):
    X, y = _blob_data(rng)
    accs = []
    for cls in (IncrementalRandomForest, JaxForest):
        f = cls(height=6, n_trees=5, n_classes=2, seed=1)
        f.fit(X[:200], y[:200])
        a1 = f.test(X[200:], y[200:])
        f.fit_inc(X[200:], y[200:])
        accs.append((a1, f.test(X, y), f.predict(X).tolist(),
                     [_nodes(t.root) for t in f.trees]))
    assert accs[0] == accs[1]
    assert accs[0][0] > 0.9 and accs[0][1] > 0.9


def test_load_module_sql_roundtrip(rng, tmp_path):
    """dt2.a's flow: LOAD MODULE, newtree, fit(pack(...)), predict, test."""
    X, y = _blob_data(rng, n=200)
    rows = ", ".join(
        f"({r[0]:.4f}, {r[1]:.4f}, {r[2]:.4f}, {r[3]:.4f}, {int(c)})"
        for r, c in zip(X, y))
    got = []
    for db, irf in ((aquery2_tpu_torch.connect(device="cpu",
                                               base_dir=str(tmp_path)),
                     PORT_IRF),
                    (aquery2_tpu.connect(base_dir=str(tmp_path)), JAX_IRF)):
        db.execute(f"""LOAD MODULE FROM "{irf}" FUNCTIONS (
            newtree(height:int, f:int64, sparse:vecint, forget:double,
                    maxf:int64, noclasses:int64, e:int) -> bool,
            fit(X:vecvecdouble, y:vecint64) -> bool,
            predict(X:vecvecdouble) -> vecint,
            test(X:vecvecdouble, y:vecint64) -> double
        );""")
        db.execute("create table source(x1 double, x2 double, x3 double, "
                   "x4 double, x5 int64)")
        db.execute(f"insert into source values {rows}")
        db.execute("create table sparse(x int)")
        db.execute("insert into sparse values (1), (1), (1), (1)")
        out = [db.execute("select newtree(6, 4, sparse.x, 0, 4, 2, 0) "
                          "from sparse").scalar(),
               db.execute("select fit(pack(x1, x2, x3, x4), x5) "
                          "from source").scalar(),
               [r[0] for r in db.execute(
                   "select predict(pack(x1, x2, x3, x4)) from source")
                .rows()],
               db.execute("select test(pack(x1, x2, x3, x4), x5) "
                          "from source").scalar()]
        got.append(out)
        db.close()
    assert got[0] == got[1]
    assert got[0][0] in (True, 1) and got[0][1] in (True, 1)
    assert (np.asarray(got[0][2]) == y).mean() > 0.9 and got[0][3] > 0.9


def test_electricity_csv_bytes_match(tmp_path):
    electricity_csv(str(tmp_path / "t.csv"), n=120, seed=101)
    jax_electricity(str(tmp_path / "j.csv"), n=120, seed=101)
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_demo_matches_jax_demo(tmp_path):
    """The demo's stream, batches, procedures and conditional trigger
    through both packages: the same accuracy after each batch, the last
    above 0.8, no trigger error; its files stay under base_dir."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ts = aquery2_tpu_torch.connect(device="cpu", base_dir=str(tmp_path / "t"))
    errors = []
    ts.log_error = errors.append
    js = aquery2_tpu.connect(base_dir=str(tmp_path / "j"))
    mine = demo.run(ts, str(tmp_path / "t"), log=lambda _: None)
    theirs = demo.run(js, str(tmp_path / "j"), irf_path=JAX_IRF,
                      log=lambda _: None)
    ts.close()
    js.close()
    assert errors == []
    assert mine == theirs and mine[-1] > 0.8
    assert sorted(os.listdir(tmp_path / "t" / "procedures")) == \
        ["democa.aqp", "democq.aqp"]


def test_demo_main_on_cpu(tmp_path, capsys):
    assert demo.main(["--device", "cpu"], base_dir=str(tmp_path)) == 0
    out = capsys.readouterr().out
    assert "batch 2: rows=360" in out and "demo OK" in out
