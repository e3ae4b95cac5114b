"""CART decision tree (NumPy).

Counterpart of the reference's `sdk/DecisionTree.h` /
`incrementalDecisionTree.cpp` (gini-split binary trees with incremental
updates). Re-designed: batch CART with quantile candidate thresholds;
incrementality is handled at the forest level (reservoir + refit,
models/random_forest.py) rather than in-node statistics surgery.
"""

from __future__ import annotations

import numpy as np


class _Node:
    __slots__ = ("feature", "threshold", "left", "right", "prediction")

    def __init__(self):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.prediction = 0


def _gini_gain(y_left: np.ndarray, y_right: np.ndarray, n_classes: int) -> float:
    def gini(y):
        if len(y) == 0:
            return 0.0
        p = np.bincount(y, minlength=n_classes) / len(y)
        return 1.0 - (p * p).sum()

    n = len(y_left) + len(y_right)
    return -(len(y_left) * gini(y_left) + len(y_right) * gini(y_right)) / n


class DecisionTree:
    def __init__(self, max_depth: int = 8, min_samples: int = 2,
                 n_thresholds: int = 16, feature_subset: int | None = None,
                 rng: np.random.Generator | None = None):
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.n_thresholds = n_thresholds
        self.feature_subset = feature_subset
        self.rng = rng or np.random.default_rng()
        self.root: _Node | None = None
        self.n_classes = 2

    def fit(self, X: np.ndarray, y: np.ndarray, n_classes: int | None = None):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.int64)
        self.n_classes = int(n_classes or (y.max() + 1 if len(y) else 2))
        self.root = self._build(X, y, 0)
        return self

    def _build(self, X, y, depth) -> _Node:
        node = _Node()
        node.prediction = int(np.bincount(y, minlength=self.n_classes).argmax()) \
            if len(y) else 0
        if depth >= self.max_depth or len(y) < self.min_samples \
                or len(np.unique(y)) <= 1:
            return node
        nfeat = X.shape[1]
        feats = np.arange(nfeat)
        if self.feature_subset and self.feature_subset < nfeat:
            feats = self.rng.choice(nfeat, self.feature_subset, replace=False)
        best = (0.0, -1, 0.0)  # (gain, feature, threshold)
        base = _gini_gain(y, np.empty(0, np.int64), self.n_classes)
        for f in feats:
            col = X[:, f]
            qs = np.unique(np.quantile(
                col, np.linspace(0.05, 0.95, self.n_thresholds)))
            for t in qs:
                m = col <= t
                if m.all() or not m.any():
                    continue
                gain = _gini_gain(y[m], y[~m], self.n_classes) - base
                if gain > best[0] + 1e-12:
                    best = (gain, int(f), float(t))
        if best[1] < 0:
            return node
        node.feature, node.threshold = best[1], best[2]
        m = X[:, node.feature] <= node.threshold
        node.left = self._build(X[m], y[m], depth + 1)
        node.right = self._build(X[~m], y[~m], depth + 1)
        return node

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.zeros(len(X), dtype=np.int64)
        # iterative batch traversal: partition index sets per node
        stack = [(self.root, np.arange(len(X)))]
        while stack:
            node, idx = stack.pop()
            if node is None or len(idx) == 0:
                continue
            if node.left is None:
                out[idx] = node.prediction
                continue
            m = X[idx, node.feature] <= node.threshold
            stack.append((node.left, idx[m]))
            stack.append((node.right, idx[~m]))
        return out
