"""DT-HW compiler front door: tree -> rule table -> ternary LUT -> TCAM tiles.

``compile_tree`` performs the paper's full DT-HW pipeline (§II.A) and the
synthesizer mapping step (§II.C.1); ``DT2CAM.fit`` adds CART training so the
whole framework is one call from raw data.  ``DT2CAM.infer`` evaluates the
compiled TCAM on the numpy oracle (``backend="sim"``) or on the CUDA match
kernels (``backend="torch"``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from .cart import DecisionTree, predict, train_tree
from .encode import encode_inputs, encode_table
from .energy import DEFAULT_HW, HardwareParams
from .lut import TernaryLUT
from .nonideal import IDEAL, NonIdealSpec, apply_saf, noisy_inputs
from .reduce import RuleTable, reduce_tree
from .simulate import SimResult, simulate
from .synth import TCAMLayout, synthesize

__all__ = [
    "CompiledDT", "compile_tree", "DT2CAM", "FeatureMismatch",
    "check_feature_count",
]

BACKENDS = ("sim", "torch")


class FeatureMismatch(ValueError):
    """Input feature count does not match the compiled model's.

    Raised by the inference entry points (``DT2CAM.infer``,
    ``TCAMServer.submit``) *before* encoding, so a wrong-width input fails
    with a clear message instead of a shape broadcast error deep inside
    ``pad_inputs``.
    """


def check_feature_count(X: np.ndarray, n_features: int, *,
                        who: str = "infer") -> np.ndarray:
    """Validate a (batch, features) matrix against the model's feature count.

    Returns ``X`` as a float64 2-D array; raises :class:`FeatureMismatch` on
    a width mismatch and ``ValueError`` on a non-2-D input.
    """
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2:
        raise ValueError(
            f"{who} expects a 2-D (batch, features) array, got shape {X.shape}"
        )
    if X.shape[1] != n_features:
        raise FeatureMismatch(
            f"{who}: input has {X.shape[1]} features but the compiled model "
            f"expects {n_features}"
        )
    return X


@dataclasses.dataclass
class CompiledDT:
    tree: DecisionTree
    table: RuleTable
    lut: TernaryLUT
    layout: TCAMLayout

    @property
    def lut_shape(self) -> tuple[int, int]:
        """(rows, width) — the paper's 'LUT Size' column in Table V."""
        return (self.lut.n_rows, self.lut.width)


def compile_tree(
    tree: DecisionTree, s: int = 128, *, nan_full_dontcare: bool = True,
    seed: int = 0, spare_rows: int = 0,
) -> CompiledDT:
    table = reduce_tree(tree)
    lut = encode_table(table, nan_full_dontcare=nan_full_dontcare)
    layout = synthesize(lut, s, seed=seed, spare_rows=spare_rows)
    return CompiledDT(tree=tree, table=table, lut=lut, layout=layout)


class DT2CAM:
    """End-to-end framework object: fit a CART tree, compile to TCAM, infer.

    >>> m = DT2CAM(s=128).fit(X_train, y_train)
    >>> result = m.infer(X_test, backend="torch")     # ideal hardware, GPU
    >>> result.accuracy(y_test) == m.golden_accuracy(X_test, y_test)
    """

    def __init__(
        self,
        s: int = 128,
        *,
        max_depth: int = 12,
        min_samples_leaf: int = 1,
        hw: HardwareParams = DEFAULT_HW,
        seed: int = 0,
        spare_rows: int = 0,
    ) -> None:
        self.s = s
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.hw = hw
        self.seed = seed
        self.spare_rows = spare_rows
        self.compiled: Optional[CompiledDT] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "DT2CAM":
        tree = train_tree(
            X, y, max_depth=self.max_depth, min_samples_leaf=self.min_samples_leaf
        )
        self.compiled = compile_tree(
            tree, self.s, seed=self.seed, spare_rows=self.spare_rows
        )
        return self

    # -- golden reference (paper: 'accuracy obtained in Python') --
    def golden_predict(self, X: np.ndarray) -> np.ndarray:
        if self.compiled is None:
            raise RuntimeError("call fit() first")
        return predict(self.compiled.tree, X)

    def golden_accuracy(self, X: np.ndarray, y: np.ndarray) -> float:
        return float((self.golden_predict(X) == np.asarray(y)).mean())

    # -- hardware-functional inference (unified front door) --
    def infer(
        self,
        X: np.ndarray,
        *,
        backend: str = "sim",
        engine: str = "auto",
        nonideal: Optional[NonIdealSpec] = None,
        selective_precharge: bool = True,
        rng: Optional[np.random.Generator] = None,
        device: DeviceLike = None,
    ) -> SimResult:
        """Run hardware-functional inference and return a ``SimResult``.

        backend='sim' evaluates on the numpy oracle (``core.simulate``);
        backend='torch' runs the match on ``device`` (``kernels.tcam_infer``)
        — bit-identical results on ideal hardware, and identical under
        non-idealities too when seeded with the same ``rng``: stuck faults,
        then input noise, then the SA offsets are drawn in that order on
        both backends, and the kmax lowering is exact.

        ``engine`` only applies to backend='torch' ('auto' picks the
        bit-packed kernel when legal, else the bitplane kernel).
        """
        if self.compiled is None:
            raise RuntimeError("call fit() first")
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of {BACKENDS}"
            )
        dev = resolve_device(device)
        X = check_feature_count(
            X, self.compiled.tree.n_features, who="DT2CAM.infer"
        )
        spec = nonideal if nonideal is not None else IDEAL
        rng = rng or np.random.default_rng(self.seed)
        layout = self.compiled.layout
        if spec.has_saf:
            layout = dataclasses.replace(
                layout, cells=apply_saf(layout.cells, spec.p_sa0, spec.p_sa1, rng)
            )
        Xn = noisy_inputs(X, spec.sigma_in, rng)
        xbits = encode_inputs(self.compiled.lut, Xn)

        if backend == "sim":
            return simulate(
                layout,
                xbits,
                hw=self.hw,
                selective_precharge=selective_precharge,
                sa_sigma=spec.sa_sigma,
                rng=rng,
            )

        from ..kernels import sa_kmax, tcam_infer

        kmax = None
        if spec.sa_sigma > 0:
            # same draw (shape and rng position) as simulate's offsets
            offsets = rng.normal(
                0.0, spec.sa_sigma,
                size=(layout.cells.shape[0], layout.n_cwd),
            )
            kmax = sa_kmax(layout, offsets, self.hw)
        return tcam_infer(
            layout,
            xbits,
            hw=self.hw,
            kmax=kmax,
            engine=engine,
            selective_precharge=selective_precharge,
            device=dev,
        )
