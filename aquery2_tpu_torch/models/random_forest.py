"""Incremental random forest.

Counterpart of the reference's libirf module (sdk/RF.{h,cpp},
sdk/irf.cpp — `newtree/fit/fit_inc/predict/test/additem` callable from
SQL). Incremental semantics follow the reference's *forgetting* design:
`fit_inc` appends new samples to a bounded reservoir with exponential
forgetting (the `forget` rate from `newtree`) and refits a randomized
subset of trees — old data's influence decays as the reservoir turns
over (reference decays node statistics in place; refit-on-reservoir is
the vectorized equivalent).
"""

from __future__ import annotations

import numpy as np

from aquery2_tpu_torch.models.decision_tree import DecisionTree


class IncrementalRandomForest:
    def __init__(self, height: int = 8, n_features: int = 0,
                 forget: float = 0.0, max_features: int = 0,
                 n_classes: int = 2, n_trees: int = 8,
                 reservoir: int = 100_000, seed: int = 0):
        self.height = int(height)
        self.n_features = int(n_features)
        self.forget = float(forget)
        self.max_features = int(max_features) or None
        self.n_classes = max(int(n_classes), 2)
        self.n_trees = max(int(n_trees), 1)
        self.reservoir = int(reservoir)
        self.rng = np.random.default_rng(seed)
        self.trees: list[DecisionTree] = []
        self._X: np.ndarray | None = None
        self._y: np.ndarray | None = None
        # additem staging (reference sdk additem API, tests/dt.a)
        self._stage: list[np.ndarray] = []
        self._stage_y: list[int] = []

    # -- data management ---------------------------------------------------

    def _absorb(self, X: np.ndarray, y: np.ndarray) -> None:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        y = np.asarray(y, dtype=np.int64).ravel()
        if X.size == 0 or len(y) == 0:
            return
        if self._X is not None and self._X.size == 0:
            self._X = None
            self._y = None
        if self._X is None:
            self._X, self._y = X.copy(), y.copy()
        else:
            self._X = np.concatenate([self._X, X])
            self._y = np.concatenate([self._y, y])
        if len(self._y) > self.reservoir:
            # forgetting: drop oldest rows preferentially; `forget` biases
            # how aggressively history is shed (reference decay factor)
            excess = len(self._y) - self.reservoir
            drop = int(excess * (1.0 + self.forget))
            drop = min(drop, len(self._y) - 1)
            self._X = self._X[drop:]
            self._y = self._y[drop:]

    # -- SQL-visible API ---------------------------------------------------

    def fit(self, X, y) -> bool:
        self._absorb(X, y)
        self._refit(range(self.n_trees))
        return True

    def fit_inc(self, X, y) -> bool:
        self._absorb(X, y)
        k = max(1, self.n_trees // 2)
        which = self.rng.choice(self.n_trees, k, replace=False)
        self._refit(which)
        return True

    def _refit(self, which) -> None:
        if self._X is None or len(self._y) == 0:
            return
        while len(self.trees) < self.n_trees:
            self.trees.append(self._new_tree())
        n = len(self._y)
        for i in which:
            idx = self.rng.integers(0, n, n)  # bootstrap
            self.trees[int(i)] = self._new_tree().fit(
                self._X[idx], self._y[idx], n_classes=self.n_classes)

    def _new_tree(self) -> DecisionTree:
        return DecisionTree(max_depth=self.height,
                            feature_subset=self.max_features,
                            rng=self.rng)

    def predict(self, X) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        fitted = [t for t in self.trees if t.root is not None]
        if not fitted:
            return np.zeros(len(X), dtype=np.int32)
        votes = np.stack([t.predict(X) for t in fitted])   # [T, n]
        out = np.zeros(len(X), dtype=np.int32)
        for j in range(len(X)):
            out[j] = np.bincount(votes[:, j], minlength=self.n_classes).argmax()
        return out

    def test(self, X, y) -> float:
        pred = self.predict(X)
        y = np.asarray(y, dtype=np.int64).ravel()
        return float((pred == y).mean()) if len(y) else 0.0

    def additem(self, col, label, size) -> bool:
        """Reference additem (tests/dt.a): stage one sample per call from
        a column of feature values; size>0 on the first call declares the
        feature count, -1 continues the staged sample set."""
        col = np.asarray(col, dtype=np.float64).ravel()
        self._stage.append(col)
        self._stage_y.append(int(label))
        return True

    def flush_staged(self) -> bool:
        if not self._stage:
            return False
        width = min(len(c) for c in self._stage)
        X = np.stack([c[:width] for c in self._stage])
        y = np.asarray(self._stage_y, dtype=np.int64)
        self._stage.clear()
        self._stage_y.clear()
        self._absorb(X, y)
        self._refit(range(self.n_trees))
        return True
