"""Model library: the engine's ML extension modules.

The reference ships one flagship user module — an incremental random
forest driven from SQL (sdk/RF.cpp, sdk/incrementalDecisionTree.cpp,
loaded via `LOAD MODULE FROM "libirf.so" FUNCTIONS (newtree/fit/
fit_inc/predict/test/additem ...)`, tests/dt.a, dt2.a, rf.a, demo/).

Here the equivalent is a Python module on numpy, on the host (a module
gets host copies of its arguments), a copy of the JAX package's models:
the same seed gives the same trees, predictions and accuracy. Load it
with

    LOAD MODULE FROM "aquery2_tpu_torch/models/irf.py" FUNCTIONS (
        newtree(height:int, f:int64, sparse:vecint, forget:double,
                maxf:int64, noclasses:int64, e:int) -> bool,
        fit(X:vecvecdouble, y:vecint64) -> bool,
        fit_inc(X:vecvecdouble, y:vecint64) -> bool,
        predict(X:vecvecdouble) -> vecint,
        test(X:vecvecdouble, y:vecint64) -> double
    );
"""

from aquery2_tpu_torch.models.random_forest import IncrementalRandomForest
from aquery2_tpu_torch.models.decision_tree import DecisionTree
