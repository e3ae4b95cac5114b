"""SQL-loadable incremental random forest module.

Drop-in counterpart of the reference's `libirf.so` surface
(sdk/irf.cpp: newtree/additem/fit/fit_inc/predict/test registered via
LOAD MODULE, tests/dt.a, dt2.a, rf.a, demo/prep.a):

    LOAD MODULE FROM "aquery2_tpu_torch/models/irf.py" FUNCTIONS (
        newtree(height:int, f:int64, sparse:vecint, forget:double,
                maxf:int64, noclasses:int64, e:int) -> bool,
        fit(X:vecvecdouble, y:vecint64) -> bool,
        fit_inc(X:vecvecdouble, y:vecint64) -> bool,
        predict(X:vecvecdouble) -> vecint,
        test(X:vecvecdouble, y:vecint64) -> double
    );

Module state is process-global like the reference's (one forest per
loaded module instance).
"""

from __future__ import annotations

import numpy as np

from aquery2_tpu_torch.models.random_forest import IncrementalRandomForest

_forest: IncrementalRandomForest | None = None


def newtree(height, f, sparse, forget, *rest) -> bool:
    """Variadic to match the reference's several signatures:
    (h, f, sparse, forget, maxf, noclasses, e[, r[, rb]]) — dt2.a — and
    (h, f, sparse, forget, noclasses, e) — demo/prep.a."""
    global _forest
    rest = list(rest)
    if len(rest) >= 3:
        maxf, noclasses = int(rest[0]), int(rest[1])
    elif len(rest) == 2:
        maxf, noclasses = 0, int(rest[0])
    else:
        maxf, noclasses = 0, 2
    _forest = IncrementalRandomForest(
        height=int(np.asarray(height).ravel()[0]) if hasattr(height, "__len__") else int(height),
        n_features=int(np.asarray(f).ravel()[0]) if hasattr(f, "__len__") else int(f),
        forget=float(np.asarray(forget).ravel()[0]) if hasattr(forget, "__len__") else float(forget),
        max_features=maxf,
        n_classes=noclasses,
    )
    return True


def _require() -> IncrementalRandomForest:
    if _forest is None:
        raise RuntimeError("call newtree(...) before fit/predict")
    return _forest


def fit(X, y) -> bool:
    fr = _require()
    if fr._stage:          # additem-staged samples pending (tests/dt.a)
        return fr.flush_staged()
    return fr.fit(X, y)


def fit_inc(X, y) -> bool:
    return _require().fit_inc(X, y)


def additem(col, label, size) -> bool:
    return _require().additem(col, label, size)


def predict(X=None):
    fr = _require()
    if X is None:          # tests/dt.a: predict() on staged/absorbed data
        X = fr._X if fr._X is not None else np.zeros((0, 1))
    return fr.predict(X)


def test(X, y) -> float:
    return _require().test(X, y)
