"""CART decision-tree trainer (pure numpy).

Copy of src/repro/core/classifier/tree.py: the port imports nothing of the
JAX package, so it keeps its own copy of this numpy module.  The same data
trains the identical tree in both packages.

The paper generates its classifier with scikit-learn (§3.1.2) and reports a
tree of ~180 nodes, depth 8.  This trainer reproduces the relevant subset:
Gini-impurity binary splits on continuous features, max-depth / min-samples
stopping, no pruning.  Determinism: ties in gain break toward the lower
feature index, then lower threshold — so retraining on the same data yields
the identical tree (important for reproducible EXPERIMENTS.md numbers).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1  # -1 => leaf
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    label: int = 0
    n_samples: int = 0


@dataclasses.dataclass
class DecisionTree:
    nodes: List[_Node]
    num_features: int
    num_classes: int
    max_depth: int

    # -- inference ----------------------------------------------------------

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, np.float32))
        out = np.empty(X.shape[0], np.int32)
        for i, x in enumerate(X):
            n = 0
            node = self.nodes[0]
            while node.feature >= 0:
                n = node.left if x[node.feature] <= node.threshold else node.right
                node = self.nodes[n]
            out[i] = node.label
        return out

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_leaves(self) -> int:
        return sum(1 for n in self.nodes if n.feature < 0)

    def depth(self) -> int:
        def _d(i: int) -> int:
            n = self.nodes[i]
            if n.feature < 0:
                return 0
            return 1 + max(_d(n.left), _d(n.right))

        return _d(0)


def _gini(counts: np.ndarray) -> float:
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts / total
    return float(1.0 - np.sum(p * p))


def _best_split(
    X: np.ndarray, y: np.ndarray, num_classes: int
) -> Optional[tuple]:
    """Exhaustive best (feature, threshold) by Gini gain. O(F * N log N)."""
    n, F = X.shape
    parent_counts = np.bincount(y, minlength=num_classes)
    parent_gini = _gini(parent_counts)
    best = None  # (gain, feature, threshold)
    for f in range(F):
        order = np.argsort(X[:, f], kind="stable")
        xs, ys = X[order, f], y[order]
        left = np.zeros(num_classes, np.int64)
        right = parent_counts.astype(np.int64).copy()
        for i in range(n - 1):
            c = ys[i]
            left[c] += 1
            right[c] -= 1
            if xs[i] == xs[i + 1]:
                continue
            nl, nr = i + 1, n - i - 1
            gain = parent_gini - (nl * _gini(left) + nr * _gini(right)) / n
            thr = float((xs[i] + xs[i + 1]) / 2.0)
            key = (-gain, f, thr)
            if best is None or key < best:
                best = key
    if best is None or -best[0] <= 1e-12:
        return None
    return (-best[0], best[1], best[2])


def train_tree(
    X: np.ndarray,
    y: np.ndarray,
    num_classes: int,
    max_depth: int = 8,
    min_samples_split: int = 8,
    min_samples_leaf: int = 4,
) -> DecisionTree:
    """Paper defaults: depth 8 (§3.1.2 (4) reports depth 8, ~180 nodes)."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    nodes: List[_Node] = []

    def build(idx: np.ndarray, depth: int) -> int:
        counts = np.bincount(y[idx], minlength=num_classes)
        me = len(nodes)
        nodes.append(_Node(label=int(np.argmax(counts)), n_samples=len(idx)))
        if (
            depth >= max_depth
            or len(idx) < min_samples_split
            or np.count_nonzero(counts) <= 1
        ):
            return me
        split = _best_split(X[idx], y[idx], num_classes)
        if split is None:
            return me
        _, f, thr = split
        go_left = X[idx, f] <= thr
        li, ri = idx[go_left], idx[~go_left]
        if len(li) < min_samples_leaf or len(ri) < min_samples_leaf:
            return me
        nodes[me].feature = f
        nodes[me].threshold = thr
        nodes[me].left = build(li, depth + 1)
        nodes[me].right = build(ri, depth + 1)
        return me

    build(np.arange(len(y)), 0)
    return DecisionTree(
        nodes=nodes,
        num_features=X.shape[1],
        num_classes=num_classes,
        max_depth=max_depth,
    )
