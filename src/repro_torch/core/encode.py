"""Ternary adaptive encoding (paper §II.A.4, Eqns 1-4, Fig 1).

Per feature i with T_i unique thresholds (from the reduced rule table), use
n_i = T_i + 1 unary bits.  Exclusive range r_k (1-indexed, k = 1..n_i) gets the
normal-form unary code with k trailing ones: r_1 -> 00..01, r_{n_i} -> 11..11.
A rule spanning exclusive ranges [LB, UB] is encoded as u_{r_LB} with the bits
where u_{r_LB} and u_{r_UB} differ replaced by don't-cares (Eqns 3-4).

Inputs are encoded with the same scheme: value v falls in exclusive range
k = 1 + #{th < v}, and is represented by that range's exact code.
"""
from __future__ import annotations

import numpy as np

from .lut import CELL_0, CELL_1, CELL_X, TernaryLUT
from .reduce import CMP_BETWEEN, CMP_GT, CMP_LE, CMP_NONE, RuleTable

__all__ = [
    "unary_code",
    "span_code",
    "feature_thresholds",
    "encode_table",
    "encode_inputs",
]


def unary_code(k: int, n: int) -> np.ndarray:
    """Normal-form unary code for exclusive range k (1-indexed) of n ranges:
    k trailing ones.  unary_code(1, 5) -> 00001, unary_code(5, 5) -> 11111."""
    if not 1 <= k <= n:
        raise ValueError(f"range index {k} out of [1, {n}]")
    code = np.zeros(n, dtype=np.int8)
    code[n - k:] = CELL_1
    return code


def span_code(lb: int, ub: int, n: int) -> np.ndarray:
    """Code for a rule spanning exclusive ranges [lb, ub] (Eqns 3-4):
    start from u_{r_lb}, write 'x' where u_{r_lb} XOR u_{r_ub} == 1."""
    if not 1 <= lb <= ub <= n:
        raise ValueError(f"bad span [{lb}, {ub}] of {n}")
    lo, hi = unary_code(lb, n), unary_code(ub, n)
    out = lo.copy()
    out[lo != hi] = CELL_X
    return out


def feature_thresholds(table: RuleTable) -> list[np.ndarray]:
    """Sorted unique thresholds per feature, T_i = |∪_j {Th1_ij, Th2_ij}|."""
    ths: list[np.ndarray] = []
    for j in range(table.n_features):
        vals = np.concatenate([table.th1[:, j], table.th2[:, j]])
        vals = np.unique(vals[np.isfinite(vals)])
        ths.append(vals)
    return ths


def _range_index(v: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Exclusive range index (1-based) of values v: 1 + #{th < v}.
    Range k is (th_{k-1}, th_k] with th_0=-inf, th_n=+inf."""
    if thresholds.size == 0:
        return np.ones(np.shape(v), dtype=np.int64)
    return 1 + np.searchsorted(thresholds, v, side="left").astype(np.int64)
    # side='left': count of th strictly < v is searchsorted-left for v > th
    # (v == th -> not counted -> v lands in the range it closes, inclusive ']')


def encode_table(table: RuleTable, *, nan_full_dontcare: bool = True) -> TernaryLUT:
    """Encode a reduced rule table into the ternary LUT (the DT-HW compiler's
    final step).  ``nan_full_dontcare``: encode a no-rule feature as all-x
    (paper's 'don't care' reading); if False, use the span formula over the
    full range (yields xx..x1 — functionally identical for valid inputs)."""
    ths = feature_thresholds(table)
    widths = np.array([t.size + 1 for t in ths], dtype=np.int64)  # Eqn (1)
    offsets = np.concatenate([[0], np.cumsum(widths)])
    cells = np.zeros((table.n_rows, int(offsets[-1])), dtype=np.int8)
    for r in range(table.n_rows):
        for j in range(table.n_features):
            n = int(widths[j])
            cmp_ = int(table.comparator[r, j])
            if cmp_ == CMP_NONE:
                code = (
                    np.full(n, CELL_X, dtype=np.int8)
                    if nan_full_dontcare
                    else span_code(1, n, n)
                )
            else:
                th = ths[j]
                if cmp_ == CMP_LE:
                    lb, ub = 1, 1 + int(np.searchsorted(th, table.th1[r, j], "left"))
                elif cmp_ == CMP_GT:
                    lb = 2 + int(np.searchsorted(th, table.th1[r, j], "left"))
                    ub = n
                elif cmp_ == CMP_BETWEEN:
                    lb = 2 + int(np.searchsorted(th, table.th1[r, j], "left"))
                    ub = 1 + int(np.searchsorted(th, table.th2[r, j], "left"))
                else:
                    raise ValueError(f"bad comparator {cmp_}")
                code = span_code(lb, ub, n)
            cells[r, offsets[j]: offsets[j + 1]] = code
    return TernaryLUT(
        cells=cells,
        classes=table.classes.copy(),
        n_classes=table.n_classes,
        feat_offsets=offsets,
        thresholds=ths,
    )


def encode_inputs(lut: TernaryLUT, X: np.ndarray) -> np.ndarray:
    """Encode raw feature vectors into input bit strings (batch, width) uint8.

    Each feature value maps to the exact unary code of the exclusive range it
    falls in; codes are concatenated in feature order.
    """
    X = np.asarray(X, dtype=np.float64)
    b = X.shape[0]
    out = np.zeros((b, lut.width), dtype=np.uint8)
    for j, th in enumerate(lut.thresholds):
        lo, hi = int(lut.feat_offsets[j]), int(lut.feat_offsets[j + 1])
        n = hi - lo
        k = _range_index(X[:, j], th)  # (batch,) in 1..n
        # code with k trailing ones: bit position p (0-based from left) is 1
        # iff p >= n - k
        pos = np.arange(n)[None, :]
        out[:, lo:hi] = (pos >= (n - k)[:, None]).astype(np.uint8)
    return out
