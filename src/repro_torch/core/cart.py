"""CART decision-tree training, implemented from scratch (no sklearn offline).

Faithful to Breiman et al. CART semantics as used by the paper (§II.A.1):
binary splits of the form ``x[feature] <= threshold`` (left) / ``> threshold``
(right), greedy Gini-impurity minimisation, thresholds at midpoints between
consecutive distinct sorted feature values.  Multi-class.  Deterministic.

The tree is stored in flat arrays so it can be (a) walked by the parser and
(b) evaluated vectorised in numpy for the golden-accuracy reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["DecisionTree", "train_tree", "predict", "tree_paths", "tree_leaf_ids"]


@dataclasses.dataclass
class DecisionTree:
    """Flat-array binary decision tree.

    For node ``i``: if ``feature[i] >= 0`` it is internal, with rule
    ``x[feature[i]] <= threshold[i]`` -> go to ``left[i]`` else ``right[i]``.
    If ``feature[i] == -1`` it is a leaf predicting ``value[i]``.
    """

    feature: np.ndarray    # (nodes,) int32, -1 for leaves
    threshold: np.ndarray  # (nodes,) float64
    left: np.ndarray       # (nodes,) int32
    right: np.ndarray      # (nodes,) int32
    value: np.ndarray      # (nodes,) int32 — majority class at node
    n_features: int
    n_classes: int

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(np.sum(self.feature < 0))

    def depth(self) -> int:
        def rec(i: int) -> int:
            if self.feature[i] < 0:
                return 0
            return 1 + max(rec(self.left[i]), rec(self.right[i]))

        return rec(0)


def _gini_from_counts(counts: np.ndarray, total: np.ndarray) -> np.ndarray:
    """Gini impurity 1 - sum_c p_c^2 for count rows; total may be 0 (-> 0)."""
    total = np.maximum(total, 1e-12)
    p = counts / total[..., None]
    return 1.0 - np.sum(p * p, axis=-1)


def _best_split_feature(
    x: np.ndarray, y_onehot: np.ndarray, min_leaf: int
) -> tuple[float, float]:
    """Best (gini_weighted, threshold) for one feature column. Vectorised scan.

    Returns (inf, nan) when no valid split exists.
    """
    order = np.argsort(x, kind="stable")
    xs = x[order]
    ys = y_onehot[order]
    n = xs.shape[0]
    # prefix class counts: counts_left[i] = counts of first i samples
    cum = np.cumsum(ys, axis=0)
    total = cum[-1]
    # candidate split after position i (1..n-1) where value changes
    boundary = np.nonzero(xs[1:] > xs[:-1])[0] + 1  # split sizes
    if boundary.size == 0:
        return np.inf, np.nan
    left_n = boundary.astype(np.float64)
    right_n = n - left_n
    valid = (left_n >= min_leaf) & (right_n >= min_leaf)
    if not np.any(valid):
        return np.inf, np.nan
    boundary = boundary[valid]
    left_n = left_n[valid]
    right_n = right_n[valid]
    left_counts = cum[boundary - 1]
    right_counts = total[None, :] - left_counts
    g = (
        left_n * _gini_from_counts(left_counts, left_n)
        + right_n * _gini_from_counts(right_counts, right_n)
    ) / n
    k = int(np.argmin(g))
    b = boundary[k]
    thr = 0.5 * (xs[b - 1] + xs[b])
    # Guard against midpoint rounding to an endpoint (degenerate fp case).
    if not (xs[b - 1] < thr):
        thr = xs[b - 1]
    return float(g[k]), float(thr)


def train_tree(
    X: np.ndarray,
    y: np.ndarray,
    *,
    max_depth: int = 12,
    min_samples_leaf: int = 1,
    min_samples_split: int = 2,
    max_leaves: Optional[int] = None,
) -> DecisionTree:
    """Greedy CART training (Gini).  X: (n, f) float, y: (n,) int class ids."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.int64)
    n, f = X.shape
    n_classes = int(y.max()) + 1 if y.size else 1
    y_onehot = np.eye(n_classes, dtype=np.float64)[y]

    feature, threshold, left, right, value = [], [], [], [], []

    def new_node() -> int:
        feature.append(-1)
        threshold.append(np.nan)
        left.append(-1)
        right.append(-1)
        value.append(0)
        return len(feature) - 1

    # each split adds exactly one eventual leaf: leaves = 1 + #splits,
    # so capping splits at max_leaves - 1 enforces the leaf budget exactly
    n_splits = [0]

    def build(idx: np.ndarray, depth: int) -> int:
        node = new_node()
        counts = y_onehot[idx].sum(axis=0)
        value[node] = int(np.argmax(counts))
        pure = counts.max() == idx.size
        budget_ok = max_leaves is None or n_splits[0] + 1 < max_leaves
        if (
            depth >= max_depth
            or idx.size < min_samples_split
            or pure
            or not budget_ok
        ):
            return node
        best_g, best_thr, best_f = np.inf, np.nan, -1
        for j in range(f):
            g, thr = _best_split_feature(X[idx, j], y_onehot[idx], min_samples_leaf)
            if g < best_g - 1e-15:
                best_g, best_thr, best_f = g, thr, j
        if best_f < 0:
            return node
        parent_g = _gini_from_counts(counts[None], np.array([idx.size]))[0]
        if best_g >= parent_g - 1e-12:  # no impurity decrease
            return node
        n_splits[0] += 1
        mask = X[idx, best_f] <= best_thr
        feature[node] = best_f
        threshold[node] = best_thr
        left[node] = build(idx[mask], depth + 1)
        right[node] = build(idx[~mask], depth + 1)
        return node

    build(np.arange(n), 0)
    return DecisionTree(
        feature=np.asarray(feature, np.int32),
        threshold=np.asarray(threshold, np.float64),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        value=np.asarray(value, np.int32),
        n_features=f,
        n_classes=n_classes,
    )


def predict(tree: DecisionTree, X: np.ndarray) -> np.ndarray:
    """Golden (paper: 'Python-based DT inference') vectorised prediction."""
    X = np.asarray(X, dtype=np.float64)
    node = np.zeros(X.shape[0], dtype=np.int32)
    # iterate depth times; all paths terminate at leaves (left/right = -1)
    for _ in range(max(tree.depth(), 1)):
        is_internal = tree.feature[node] >= 0
        if not np.any(is_internal):
            break
        feat = np.maximum(tree.feature[node], 0)
        go_left = X[np.arange(X.shape[0]), feat] <= tree.threshold[node]
        nxt = np.where(go_left, tree.left[node], tree.right[node])
        node = np.where(is_internal, nxt, node)
    return tree.value[node].astype(np.int32)


def tree_leaf_ids(tree: DecisionTree) -> np.ndarray:
    """Leaf node ids in the same left-to-right DFS order as ``tree_paths``.

    Row ``r`` of the reduced rule table (and hence of the encoded LUT)
    corresponds to leaf node ``tree_leaf_ids(tree)[r]`` — the hook that lets
    per-leaf side tables (e.g. ensemble class-probability storage in
    a forest) be aligned with TCAM rows.
    """
    out: list[int] = []

    def rec(i: int) -> None:
        if tree.feature[i] < 0:
            out.append(i)
            return
        rec(int(tree.left[i]))
        rec(int(tree.right[i]))

    rec(0)
    return np.asarray(out, dtype=np.int64)


def tree_paths(tree: DecisionTree) -> list[tuple[list[tuple[int, str, float]], int]]:
    """All root->leaf paths: ([(feature, '<='|'>', threshold), ...], class).

    This is the paper's *tree parsing* step input (§II.A.2): one path per leaf,
    ordered left-to-right (deterministic).
    """
    out: list[tuple[list[tuple[int, str, float]], int]] = []

    def rec(i: int, conds: list[tuple[int, str, float]]) -> None:
        if tree.feature[i] < 0:
            out.append((list(conds), int(tree.value[i])))
            return
        f, t = int(tree.feature[i]), float(tree.threshold[i])
        conds.append((f, "<=", t))
        rec(int(tree.left[i]), conds)
        conds.pop()
        conds.append((f, ">", t))
        rec(int(tree.right[i]), conds)
        conds.pop()

    rec(0, [])
    return out
