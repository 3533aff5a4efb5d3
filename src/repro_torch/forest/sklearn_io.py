"""sklearn interop: lossless import of fitted sklearn trees/forests.

Converts ``sklearn.tree._tree.Tree`` flat arrays into the repo's
``DecisionTree`` (same split semantics: ``x[f] <= threshold`` goes left) and
extracts the per-leaf class-probability tables needed to reproduce
``RandomForestClassifier.predict`` *bit-exactly*:

* leaf probabilities replicate ``DecisionTreeClassifier.predict_proba``
  including its normalizer quirk (rows summing to zero divide by 1);
* probabilities are indexed by LUT row via ``tree_leaf_ids`` (both the rule
  table and the DFS leaf walk enumerate leaves left-to-right);
* sklearn casts inputs to float32 inside ``predict`` — the importer records
  that so the forest front door applies the same cast before encoding.

Everything here is numpy-only and degrades gracefully: when sklearn is not
installed, ``is_sklearn_forest`` simply returns False.
"""
from __future__ import annotations

import numpy as np

from ..core.cart import DecisionTree, tree_leaf_ids

__all__ = [
    "is_sklearn_forest", "from_sklearn_tree", "leaf_proba_rows",
]


def is_sklearn_forest(obj) -> bool:
    """Duck-typed check for a fitted sklearn forest ensemble
    (``RandomForestClassifier``-like: ``estimators_`` + ``classes_``)."""
    return hasattr(obj, "estimators_") and hasattr(obj, "classes_")


def from_sklearn_tree(estimator) -> DecisionTree:
    """Convert a fitted ``DecisionTreeClassifier`` to a ``DecisionTree``.

    sklearn leaves carry ``feature == TREE_UNDEFINED`` (-2) — mapped to the
    repo's -1 sentinel; split rule and child order are identical
    (``x[f] <= threshold`` -> left child).
    """
    t = estimator.tree_
    feature = np.asarray(t.feature, dtype=np.int32)
    feature = np.where(feature < 0, -1, feature).astype(np.int32)
    value = np.asarray(t.value, dtype=np.float64)[:, 0, :]
    return DecisionTree(
        feature=feature,
        threshold=np.asarray(t.threshold, dtype=np.float64),
        left=np.asarray(t.children_left, dtype=np.int32),
        right=np.asarray(t.children_right, dtype=np.int32),
        value=np.argmax(value, axis=1).astype(np.int32),
        n_features=int(t.n_features),
        n_classes=int(value.shape[1]),
    )


def leaf_proba_rows(estimator, tree: DecisionTree) -> np.ndarray:
    """(n_leaves, n_classes) float64 leaf probabilities in LUT-row order.

    Row ``r`` of the compiled LUT corresponds to leaf ``tree_leaf_ids[r]``;
    each row replicates ``DecisionTreeClassifier.predict_proba`` bit-for-bit:
    ``value[leaf] / sum`` with zero sums divided by 1 instead.
    """
    raw = np.asarray(estimator.tree_.value, dtype=np.float64)[:, 0, :]
    normalizer = raw.sum(axis=1)[:, np.newaxis]
    normalizer[normalizer == 0.0] = 1.0
    proba = raw / normalizer
    return np.ascontiguousarray(proba[tree_leaf_ids(tree)])
