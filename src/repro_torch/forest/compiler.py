"""Forest -> multi-bank TCAM compiler (numpy-only front half).

``compile_forest`` lowers every tree of an ensemble through the existing
single-tree pipeline (``compile_tree``: reduce -> encode -> synthesize) into
one ``ForestBank`` per tree — each bank an independent tiled ``TCAMLayout``
with its own input encoding — plus the voting metadata needed to aggregate
per-bank matches into an ensemble decision:

* ``vote='soft'`` (sklearn default): per-leaf class-probability tables in
  LUT-row order; votes accumulate in estimator order and reproduce
  ``RandomForestClassifier.predict`` bit-exactly (including sklearn's
  float32 input cast, recorded as ``cast_f32``).
* ``vote='hard'`` (native CART default): one class vote per bank, argmax
  with ties to the lowest class index.

``forest_infer_ref`` is the pure-numpy reference executor (one
``core.simulate`` pass per bank); the banked PyTorch/CUDA paths live in
``forest.executor`` and are validated against it bit-exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from ..core.cart import DecisionTree, train_tree
from ..core.compiler import CompiledDT, check_feature_count, compile_tree
from ..core.encode import encode_inputs
from ..core.energy import DEFAULT_HW, HardwareParams, forest_figures
from ..core.simulate import simulate
from .sklearn_io import from_sklearn_tree, is_sklearn_forest, leaf_proba_rows

__all__ = [
    "ForestBank", "CompiledForest", "ForestResult", "compile_forest",
    "train_forest", "aggregate_votes", "forest_infer_ref", "VOTES",
]

VOTES = ("soft", "hard")


@dataclasses.dataclass
class ForestBank:
    """One tree of the ensemble, compiled onto its own TCAM bank."""

    compiled: CompiledDT
    proba: Optional[np.ndarray] = None  # (n_rows, n_classes) f64, soft vote

    @property
    def layout(self):
        return self.compiled.layout

    @property
    def lut(self):
        return self.compiled.lut


@dataclasses.dataclass
class CompiledForest:
    """A compiled ensemble: per-tree banks + vote aggregation metadata.

    ``classes`` maps internal class indices to output labels (sklearn's
    ``classes_``, or ``arange(n_classes)`` for native trees); ``cast_f32``
    records whether inputs must round-trip through float32 before encoding
    (sklearn does this inside ``predict`` — required for bit-exact parity).
    """

    banks: list[ForestBank]
    n_features: int
    n_classes: int
    classes: np.ndarray
    vote: str
    cast_f32: bool
    s: int

    @property
    def n_banks(self) -> int:
        return len(self.banks)

    @property
    def layouts(self) -> list:
        return [b.layout for b in self.banks]

    def prepare_inputs(self, X: np.ndarray, *,
                       who: str = "forest.infer") -> np.ndarray:
        """Validate the feature count and apply the recorded input cast."""
        X = check_feature_count(X, self.n_features, who=who)
        if self.cast_f32:
            X = X.astype(np.float32).astype(np.float64)
        return X


@dataclasses.dataclass
class ForestResult:
    """Ensemble inference outcome + per-bank activity trace.

    ``score`` is the sklearn-averaged probability matrix (soft vote,
    float64) or the integer vote-count matrix (hard vote), in internal class
    index space; ``predictions`` are already mapped through ``classes``.
    """

    predictions: np.ndarray     # (batch,) output labels
    score: np.ndarray           # (batch, n_classes)
    survivors: np.ndarray       # (n_banks, batch) int32 row index, -1 none
    n_survivors: np.ndarray     # (n_banks, batch) int32
    active_evals: np.ndarray    # (n_banks, batch) int64
    enabled: np.ndarray         # (n_banks,) bool — banks that voted
    engine: str
    figures: dict               # per-bank + aggregate pipelined figures

    @property
    def total_active_evals(self) -> np.ndarray:
        return self.active_evals[self.enabled].sum(axis=0)

    def accuracy(self, labels: np.ndarray) -> float:
        return float((self.predictions == np.asarray(labels)).mean())


def _compile_native(
    trees: Sequence[DecisionTree], s: int, *, seed: int, spare_rows: int,
    nan_full_dontcare: bool,
) -> list[ForestBank]:
    banks = []
    for i, tree in enumerate(trees):
        banks.append(ForestBank(compiled=compile_tree(
            tree, s, nan_full_dontcare=nan_full_dontcare,
            seed=seed + i, spare_rows=spare_rows,
        )))
    return banks


def compile_forest(
    model: Union[Sequence[DecisionTree], object],
    s: int = 128,
    *,
    vote: Optional[str] = None,
    seed: int = 0,
    spare_rows: int = 0,
    nan_full_dontcare: bool = True,
) -> CompiledForest:
    """Compile an ensemble — a sequence of native ``DecisionTree``s or a
    fitted ``sklearn.ensemble.RandomForestClassifier`` — into per-bank TCAM
    layouts plus vote metadata.

    ``vote`` defaults to 'soft' for sklearn forests (matching
    ``RandomForestClassifier.predict``) and 'hard' for native trees.
    Each bank gets ``seed + bank_index`` for its rogue-row synthesis.
    """
    if vote is not None and vote not in VOTES:
        raise ValueError(f"unknown vote {vote!r}; expected one of {VOTES}")

    if is_sklearn_forest(model):
        estimators = list(model.estimators_)
        if not estimators:
            raise ValueError("sklearn forest has no estimators")
        trees = [from_sklearn_tree(e) for e in estimators]
        banks = _compile_native(
            trees, s, seed=seed, spare_rows=spare_rows,
            nan_full_dontcare=nan_full_dontcare,
        )
        for bank, est, tree in zip(banks, estimators, trees):
            bank.proba = leaf_proba_rows(est, tree)
        classes = np.asarray(model.classes_)
        return CompiledForest(
            banks=banks,
            n_features=trees[0].n_features,
            n_classes=len(classes),
            classes=classes,
            vote=vote or "soft",
            cast_f32=True,
            s=s,
        )

    trees = list(model)
    if not trees:
        raise ValueError("compile_forest needs at least one tree")
    if not all(isinstance(t, DecisionTree) for t in trees):
        raise TypeError(
            "compile_forest expects a fitted sklearn RandomForestClassifier "
            "or a sequence of DecisionTree objects, got "
            f"{type(trees[0]).__name__}"
        )
    n_features = trees[0].n_features
    if any(t.n_features != n_features for t in trees):
        raise ValueError("all trees must share the same feature count")
    n_classes = max(t.n_classes for t in trees)
    banks = _compile_native(
        trees, s, seed=seed, spare_rows=spare_rows,
        nan_full_dontcare=nan_full_dontcare,
    )
    if (vote or "hard") == "soft":
        # native trees have no proba tables: soft vote degenerates to
        # one-hot leaf distributions (== hard vote with mean instead of sum)
        for bank in banks:
            cls = bank.lut.classes
            onehot = np.zeros((len(cls), n_classes), np.float64)
            onehot[np.arange(len(cls)), cls] = 1.0
            bank.proba = onehot
    return CompiledForest(
        banks=banks,
        n_features=n_features,
        n_classes=n_classes,
        classes=np.arange(n_classes),
        vote=vote or "hard",
        cast_f32=False,
        s=s,
    )


def train_forest(
    X: np.ndarray,
    y: np.ndarray,
    n_trees: int = 25,
    *,
    max_depth: int = 12,
    min_samples_leaf: int = 1,
    bootstrap: bool = True,
    seed: int = 0,
) -> list[DecisionTree]:
    """Bagged CART ensemble on the native trainer (no sklearn needed)."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.int64)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    trees = []
    for _ in range(n_trees):
        idx = rng.integers(0, n, size=n) if bootstrap else np.arange(n)
        trees.append(train_tree(
            X[idx], y[idx], max_depth=max_depth,
            min_samples_leaf=min_samples_leaf,
        ))
    return trees


def aggregate_votes(
    forest: CompiledForest,
    survivors: np.ndarray,          # (n_banks, batch) int32, -1 = no match
    enabled: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Aggregate per-bank surviving rows into ensemble predictions.

    Soft vote replicates sklearn exactly: probabilities accumulate bank by
    bank *in estimator order* (float64 addition is not associative), the sum
    divides by the number of voting banks, and argmax breaks ties toward the
    lower class index.  Hard vote counts one vote per bank.  ``enabled``
    masks out banks (BIST/repair degradation): a dead bank drops out of both
    the accumulation and the divisor, degrading the vote instead of the chip.

    Returns ``(predictions, score)``.
    """
    survivors = np.asarray(survivors)
    n_banks, batch = survivors.shape
    if n_banks != forest.n_banks:
        raise ValueError(
            f"survivors has {n_banks} banks; forest has {forest.n_banks}"
        )
    if enabled is None:
        enabled = np.ones(n_banks, dtype=bool)
    enabled = np.asarray(enabled, dtype=bool)
    n_voting = int(enabled.sum())
    if n_voting == 0:
        raise ValueError("no enabled banks to vote")

    if forest.vote == "soft":
        acc = np.zeros((batch, forest.n_classes), dtype=np.float64)
        for b in range(n_banks):
            if not enabled[b]:
                continue
            rows = survivors[b]
            proba = forest.banks[b].proba
            assert proba is not None, "soft vote needs per-bank proba tables"
            contrib = proba[np.maximum(rows, 0)]
            contrib[rows < 0] = 0.0
            acc += contrib
        score = acc / n_voting
        idx = np.argmax(score, axis=1)
    else:
        score = np.zeros((batch, forest.n_classes), dtype=np.int64)
        cols = np.arange(batch)
        for b in range(n_banks):
            if not enabled[b]:
                continue
            rows = survivors[b]
            valid = rows >= 0
            cls = forest.banks[b].layout.classes[np.maximum(rows, 0)]
            np.add.at(score, (cols[valid], cls[valid]), 1)
        idx = np.argmax(score, axis=1)
    predictions = np.asarray(forest.classes)[idx]
    return predictions, score


def forest_infer_ref(
    forest: CompiledForest,
    X: np.ndarray,
    *,
    hw: HardwareParams = DEFAULT_HW,
    selective_precharge: bool = True,
    enabled: Optional[np.ndarray] = None,
) -> ForestResult:
    """Pure-numpy reference executor: one oracle simulation per bank,
    then vote aggregation.  The banked paths are validated against this."""
    Xp = forest.prepare_inputs(X, who="forest_infer_ref")
    b = Xp.shape[0]
    survivors = np.empty((forest.n_banks, b), np.int32)
    n_survivors = np.empty((forest.n_banks, b), np.int32)
    active = np.empty((forest.n_banks, b), np.int64)
    for i, bank in enumerate(forest.banks):
        xbits = encode_inputs(bank.lut, Xp)
        res = simulate(
            bank.layout, xbits, hw=hw,
            selective_precharge=selective_precharge,
        )
        survivors[i] = res.survivors
        n_survivors[i] = res.n_survivors
        active[i] = res.active_evals
    predictions, score = aggregate_votes(forest, survivors, enabled)
    en = (np.ones(forest.n_banks, bool) if enabled is None
          else np.asarray(enabled, bool))
    figures = forest_figures(
        forest.layouts, hw,
        mean_active_evals=[float(a.mean()) for a in active],
    )
    return ForestResult(
        predictions=predictions,
        score=score,
        survivors=survivors,
        n_survivors=n_survivors,
        active_evals=active,
        enabled=en,
        engine="ref",
        figures=figures,
    )
