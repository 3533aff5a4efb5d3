"""Table II datasets (paper §III).

Offline container: UCI/Kaggle are unreachable, so

  * **Iris** is embedded (the canonical 150x4 UCI values, 3 classes).
  * The other seven datasets are **synthetic generators matched to Table II**
    (#instances, #features, #classes) with *planted axis-aligned rule
    structure* + label noise, tuned so CART trees land in the same LUT-size
    regime as the paper's Table V.  Absolute accuracies differ from the paper
    (different data); every *relative* claim (sim == golden, robustness
    trends, energy/latency scaling with S) is data-source independent.

Each dataset ships fit parameters (``max_depth``/``max_leaves``) used by the
benchmarks so LUT shapes are reproducible run-to-run (all generators are
seeded and deterministic).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = ["DatasetSpec", "DATASETS", "load", "load_split", "normalize", "IRIS"]


# --------------------------------------------------------------------------
# Embedded Fisher's Iris (canonical UCI values): 50 setosa / 50 versicolor /
# 50 virginica, features = sepal length, sepal width, petal length, petal
# width (cm).
# --------------------------------------------------------------------------
_IRIS_RAW = """
5.1 3.5 1.4 0.2 0;4.9 3.0 1.4 0.2 0;4.7 3.2 1.3 0.2 0;4.6 3.1 1.5 0.2 0
5.0 3.6 1.4 0.2 0;5.4 3.9 1.7 0.4 0;4.6 3.4 1.4 0.3 0;5.0 3.4 1.5 0.2 0
4.4 2.9 1.4 0.2 0;4.9 3.1 1.5 0.1 0;5.4 3.7 1.5 0.2 0;4.8 3.4 1.6 0.2 0
4.8 3.0 1.4 0.1 0;4.3 3.0 1.1 0.1 0;5.8 4.0 1.2 0.2 0;5.7 4.4 1.5 0.4 0
5.4 3.9 1.3 0.4 0;5.1 3.5 1.4 0.3 0;5.7 3.8 1.7 0.3 0;5.1 3.8 1.5 0.3 0
5.4 3.4 1.7 0.2 0;5.1 3.7 1.5 0.4 0;4.6 3.6 1.0 0.2 0;5.1 3.3 1.7 0.5 0
4.8 3.4 1.9 0.2 0;5.0 3.0 1.6 0.2 0;5.0 3.4 1.6 0.4 0;5.2 3.5 1.5 0.2 0
5.2 3.4 1.4 0.2 0;4.7 3.2 1.6 0.2 0;4.8 3.1 1.6 0.2 0;5.4 3.4 1.5 0.4 0
5.2 4.1 1.5 0.1 0;5.5 4.2 1.4 0.2 0;4.9 3.1 1.5 0.2 0;5.0 3.2 1.2 0.2 0
5.5 3.5 1.3 0.2 0;4.9 3.6 1.4 0.1 0;4.4 3.0 1.3 0.2 0;5.1 3.4 1.5 0.2 0
5.0 3.5 1.3 0.3 0;4.5 2.3 1.3 0.3 0;4.4 3.2 1.3 0.2 0;5.0 3.5 1.6 0.6 0
5.1 3.8 1.9 0.4 0;4.8 3.0 1.4 0.3 0;5.1 3.8 1.6 0.2 0;4.6 3.2 1.4 0.2 0
5.3 3.7 1.5 0.2 0;5.0 3.3 1.4 0.2 0;7.0 3.2 4.7 1.4 1;6.4 3.2 4.5 1.5 1
6.9 3.1 4.9 1.5 1;5.5 2.3 4.0 1.3 1;6.5 2.8 4.6 1.5 1;5.7 2.8 4.5 1.3 1
6.3 3.3 4.7 1.6 1;4.9 2.4 3.3 1.0 1;6.6 2.9 4.6 1.3 1;5.2 2.7 3.9 1.4 1
5.0 2.0 3.5 1.0 1;5.9 3.0 4.2 1.5 1;6.0 2.2 4.0 1.0 1;6.1 2.9 4.7 1.4 1
5.6 2.9 3.6 1.3 1;6.7 3.1 4.4 1.4 1;5.6 3.0 4.5 1.5 1;5.8 2.7 4.1 1.0 1
6.2 2.2 4.5 1.5 1;5.6 2.5 3.9 1.1 1;5.9 3.2 4.8 1.8 1;6.1 2.8 4.0 1.3 1
6.3 2.5 4.9 1.5 1;6.1 2.8 4.7 1.2 1;6.4 2.9 4.3 1.3 1;6.6 3.0 4.4 1.4 1
6.8 2.8 4.8 1.4 1;6.7 3.0 5.0 1.7 1;6.0 2.9 4.5 1.5 1;5.7 2.6 3.5 1.0 1
5.5 2.4 3.8 1.1 1;5.5 2.4 3.7 1.0 1;5.8 2.7 3.9 1.2 1;6.0 2.7 5.1 1.6 1
5.4 3.0 4.5 1.5 1;6.0 3.4 4.5 1.6 1;6.7 3.1 4.7 1.5 1;6.3 2.3 4.4 1.3 1
5.6 3.0 4.1 1.3 1;5.5 2.5 4.0 1.3 1;5.5 2.6 4.4 1.2 1;6.1 3.0 4.6 1.4 1
5.8 2.6 4.0 1.2 1;5.0 2.3 3.3 1.0 1;5.6 2.7 4.2 1.3 1;5.7 3.0 4.2 1.2 1
5.7 2.9 4.2 1.3 1;6.2 2.9 4.3 1.3 1;5.1 2.5 3.0 1.1 1;5.7 2.8 4.1 1.3 1
6.3 3.3 6.0 2.5 2;5.8 2.7 5.1 1.9 2;7.1 3.0 5.9 2.1 2;6.3 2.9 5.6 1.8 2
6.5 3.0 5.8 2.2 2;7.6 3.0 6.6 2.1 2;4.9 2.5 4.5 1.7 2;7.3 2.9 6.3 1.8 2
6.7 2.5 5.8 1.8 2;7.2 3.6 6.1 2.5 2;6.5 3.2 5.1 2.0 2;6.4 2.7 5.3 1.9 2
6.8 3.0 5.5 2.1 2;5.7 2.5 5.0 2.0 2;5.8 2.8 5.1 2.4 2;6.4 3.2 5.3 2.3 2
6.5 3.0 5.5 1.8 2;7.7 3.8 6.7 2.2 2;7.7 2.6 6.9 2.3 2;6.0 2.2 5.0 1.5 2
6.9 3.2 5.7 2.3 2;5.6 2.8 4.9 2.0 2;7.7 2.8 6.7 2.0 2;6.3 2.7 4.9 1.8 2
6.7 3.3 5.7 2.1 2;7.2 3.2 6.0 1.8 2;6.2 2.8 4.8 1.8 2;6.1 3.0 4.9 1.8 2
6.4 2.8 5.6 2.1 2;7.2 3.0 5.8 1.6 2;7.4 2.8 6.1 1.9 2;7.9 3.8 6.4 2.0 2
6.4 2.8 5.6 2.2 2;6.3 2.8 5.1 1.5 2;6.1 2.6 5.6 1.4 2;7.7 3.0 6.1 2.3 2
6.3 3.4 5.6 2.4 2;6.4 3.1 5.5 1.8 2;6.0 3.0 4.8 1.8 2;6.9 3.1 5.4 2.1 2
6.7 3.1 5.6 2.4 2;6.9 3.1 5.1 2.3 2;5.8 2.7 5.1 1.9 2;6.8 3.2 5.9 2.3 2
6.7 3.3 5.7 2.5 2;6.7 3.0 5.2 2.3 2;6.3 2.5 5.0 1.9 2;6.5 3.0 5.2 2.0 2
6.2 3.4 5.4 2.3 2;5.9 3.0 5.1 1.8 2
"""


def _iris() -> tuple[np.ndarray, np.ndarray]:
    rows = [r for r in _IRIS_RAW.replace("\n", ";").split(";") if r.strip()]
    arr = np.array([[float(v) for v in r.split()] for r in rows])
    assert arr.shape == (150, 5), arr.shape
    return arr[:, :4], arr[:, 4].astype(np.int64)


IRIS = _iris


# --------------------------------------------------------------------------
# Synthetic generators with planted rule structure
# --------------------------------------------------------------------------
def _planted_tree_labels(
    X: np.ndarray,
    n_classes: int,
    depth: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Label points with a random planted axis-aligned decision tree.

    The planted tree is built by recursive random splits (feature uniform,
    threshold at a random quantile of the points reaching the node), leaves
    get random classes.  This gives CART a learnable rule structure whose
    recovered tree size scales with ``depth``.
    """
    y = np.zeros(X.shape[0], dtype=np.int64)

    def rec(idx: np.ndarray, d: int) -> None:
        if d == 0 or idx.size < 8:
            y[idx] = rng.integers(0, n_classes)
            return
        f = int(rng.integers(0, X.shape[1]))
        q = float(rng.uniform(0.25, 0.75))
        thr = np.quantile(X[idx, f], q)
        mask = X[idx, f] <= thr
        if mask.all() or not mask.any():
            y[idx] = rng.integers(0, n_classes)
            return
        rec(idx[mask], d - 1)
        rec(idx[~mask], d - 1)

    rec(np.arange(X.shape[0]), depth)
    return y


def _synthetic(
    n: int,
    f: int,
    c: int,
    *,
    planted_depth: int,
    label_noise: float,
    seed: int,
    categorical_levels: Optional[int] = None,
    quantize: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    if categorical_levels:
        # ordinal-encoded categorical features (Car-style)
        X = rng.integers(0, categorical_levels, size=(n, f)).astype(np.float64)
    else:
        X = rng.uniform(0.0, 1.0, size=(n, f))
    if quantize:
        # integer-valued features (Covid-style: age/sex/region codes) — few
        # distinct values => repeated CART thresholds => narrow LUTs.
        X = np.floor(X * quantize)
    y = _planted_tree_labels(X, c, planted_depth, rng)
    flip = rng.random(n) < label_noise
    y[flip] = rng.integers(0, c, size=int(flip.sum()))
    return X, y


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_instances: int       # Table II
    n_features: int        # Table II
    n_classes: int         # Table II
    loader: Callable[[], tuple[np.ndarray, np.ndarray]]
    # CART fit params used by benchmarks to land in the Table V LUT regime
    max_depth: int = 16
    max_leaves: Optional[int] = None
    min_samples_leaf: int = 1
    # paper's Table V LUT size (rows x width), for regime reference
    paper_lut: Optional[tuple[int, int]] = None
    synthetic: bool = True


DATASETS: dict[str, DatasetSpec] = {
    "iris": DatasetSpec(
        "iris", 150, 4, 3, _iris, max_depth=5, paper_lut=(9, 12),
        synthetic=False,
    ),
    "diabetes": DatasetSpec(
        "diabetes", 768, 8, 2,
        lambda: _synthetic(768, 8, 2, planted_depth=6, label_noise=0.18, seed=11),
        max_depth=12, max_leaves=121, paper_lut=(120, 123),
    ),
    "haberman": DatasetSpec(
        "haberman", 306, 3, 2,
        lambda: _synthetic(306, 3, 2, planted_depth=7, label_noise=0.30, seed=12),
        max_depth=14, max_leaves=94, paper_lut=(93, 71),
    ),
    "car": DatasetSpec(
        "car", 1728, 6, 4,
        lambda: _synthetic(
            1728, 6, 4, planted_depth=6, label_noise=0.05, seed=13,
            categorical_levels=4,
        ),
        max_depth=12, max_leaves=77, paper_lut=(76, 20),
    ),
    "cancer": DatasetSpec(
        "cancer", 569, 30, 2,
        lambda: _synthetic(569, 30, 2, planted_depth=4, label_noise=0.05, seed=14),
        max_depth=8, max_leaves=24, paper_lut=(23, 52),
    ),
    "credit": DatasetSpec(
        "credit", 120269, 10, 2,
        lambda: _synthetic(120269, 10, 2, planted_depth=12, label_noise=0.12,
                           seed=15, quantize=400),
        max_depth=40, max_leaves=8476, paper_lut=(8475, 3580),
    ),
    "titanic": DatasetSpec(
        "titanic", 887, 6, 2,
        lambda: _synthetic(887, 6, 2, planted_depth=7, label_noise=0.20, seed=16),
        max_depth=16, max_leaves=192, paper_lut=(191, 150),
    ),
    "covid": DatasetSpec(
        "covid", 33599, 4, 2,
        lambda: _synthetic(33599, 4, 2, planted_depth=9, label_noise=0.015,
                           seed=17, quantize=40),
        max_depth=24, max_leaves=442, paper_lut=(441, 146),
    ),
}


def normalize(X: np.ndarray) -> np.ndarray:
    """Min-max normalize features to [0, 1] (the paper's input-noise study is
    on normalized features)."""
    X = np.asarray(X, dtype=np.float64)
    lo, hi = X.min(axis=0), X.max(axis=0)
    return (X - lo) / np.maximum(hi - lo, 1e-12)


def load(name: str) -> tuple[np.ndarray, np.ndarray]:
    spec = DATASETS[name]
    X, y = spec.loader()
    assert X.shape == (spec.n_instances, spec.n_features), (name, X.shape)
    assert int(y.max()) + 1 <= spec.n_classes
    return X, y


def load_split(
    name: str, *, train_frac: float = 0.9, seed: int = 0, norm: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """90/10 split (paper §III), deterministic shuffle, optional min-max norm
    (fitted on the full data, as the paper normalizes the dataset once)."""
    X, y = load(name)
    if norm:
        X = normalize(X)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(X.shape[0])
    n_tr = int(round(train_frac * X.shape[0]))
    tr, te = perm[:n_tr], perm[n_tr:]
    return X[tr], y[tr], X[te], y[te]
