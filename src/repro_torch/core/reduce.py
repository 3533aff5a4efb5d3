"""Column reduction (paper §II.A.3).

Collapses the per-path condition lists produced by tree parsing into a single
rule per (row, feature): ``(comparator, Th1, Th2)`` with comparator semantics

  '0'  -> f <= Th1                 (Th2 = NaN)
  '1'  -> f >  Th1                 (Th2 = NaN)
  '2'  -> Th1 < f <= Th2
  NaN  -> no rule on this feature in this row

By CART construction the conditions on one feature along one path always
describe a contiguous interval, so the reduction is exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cart import DecisionTree, tree_paths

__all__ = ["RuleTable", "CMP_LE", "CMP_GT", "CMP_BETWEEN", "CMP_NONE", "reduce_tree"]

CMP_LE = 0       # f <= Th1
CMP_GT = 1       # f > Th1
CMP_BETWEEN = 2  # Th1 < f <= Th2
CMP_NONE = 3     # no rule ('NaN' in the paper)


@dataclasses.dataclass
class RuleTable:
    """Reduced rule table: one row per DT path.

    comparator: (rows, features) int8 in {CMP_LE, CMP_GT, CMP_BETWEEN, CMP_NONE}
    th1, th2:   (rows, features) float64 (NaN where unused)
    classes:    (rows,) int32 leaf class per path
    """

    comparator: np.ndarray
    th1: np.ndarray
    th2: np.ndarray
    classes: np.ndarray
    n_classes: int

    @property
    def n_rows(self) -> int:
        return int(self.comparator.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.comparator.shape[1])

    def row_matches(self, X: np.ndarray) -> np.ndarray:
        """(batch, rows) bool — functional reference: does input match path?"""
        X = np.asarray(X, dtype=np.float64)
        b = X.shape[0]
        m = np.ones((b, self.n_rows), dtype=bool)
        for j in range(self.n_features):
            cmp_ = self.comparator[:, j][None, :]       # (1, rows)
            t1 = self.th1[:, j][None, :]
            t2 = self.th2[:, j][None, :]
            v = X[:, j][:, None]                        # (batch, 1)
            ok = np.where(
                cmp_ == CMP_LE, v <= t1,
                np.where(
                    cmp_ == CMP_GT, v > t1,
                    np.where(cmp_ == CMP_BETWEEN, (v > t1) & (v <= t2), True),
                ),
            )
            m &= ok
        return m


def reduce_tree(tree: DecisionTree) -> RuleTable:
    """Parse the tree into paths and reduce conditions per feature (§II.A.2-3)."""
    paths = tree_paths(tree)
    rows = len(paths)
    f = tree.n_features
    comparator = np.full((rows, f), CMP_NONE, dtype=np.int8)
    th1 = np.full((rows, f), np.nan)
    th2 = np.full((rows, f), np.nan)
    classes = np.zeros(rows, dtype=np.int32)
    for r, (conds, cls) in enumerate(paths):
        classes[r] = cls
        lo = np.full(f, -np.inf)  # strict lower bound: f > lo
        hi = np.full(f, np.inf)   # inclusive upper bound: f <= hi
        for feat, op, thr in conds:
            if op == "<=":
                hi[feat] = min(hi[feat], thr)
            else:
                lo[feat] = max(lo[feat], thr)
        for j in range(f):
            has_lo = np.isfinite(lo[j])
            has_hi = np.isfinite(hi[j])
            if has_lo and has_hi:
                comparator[r, j] = CMP_BETWEEN
                th1[r, j], th2[r, j] = lo[j], hi[j]
            elif has_hi:
                comparator[r, j] = CMP_LE
                th1[r, j] = hi[j]
            elif has_lo:
                comparator[r, j] = CMP_GT
                th1[r, j] = lo[j]
    return RuleTable(comparator, th1, th2, classes, tree.n_classes)
