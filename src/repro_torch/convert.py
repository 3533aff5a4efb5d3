"""Carry a compiled model across from the JAX package's model registry.

``compiled_from_arrays`` rebuilds a ``CompiledDT`` from the flat arrays of a
registry blob — the ``.npz`` that the JAX package's
``ModelRegistry.publish`` writes for a single tree — so a published model
loads straight into the port:

>>> with np.load(path) as z:
...     compiled = compiled_from_arrays(z)

Keys: ``tree__*`` (the fitted tree), ``tbl__*`` (the reduced rule table),
``lut__*`` with one ``lut__th_{i}`` per feature (the ternary LUT), and
``lay__*`` (the tiled layout; ``lay__dims`` holds s, n_rwd, n_cwd, n_rows,
width, n_classes).  ``prefix`` selects one model inside a blob that holds
several (a forest stores bank ``i`` under ``b{i}__``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .core.cart import DecisionTree
from .core.compiler import CompiledDT
from .core.lut import TernaryLUT
from .core.reduce import RuleTable
from .core.synth import TCAMLayout

__all__ = ["compiled_from_arrays"]


def compiled_from_arrays(z: Mapping[str, np.ndarray],
                         prefix: str = "") -> CompiledDT:
    """Rebuild the compiled tree stored under ``prefix`` in ``z``."""
    p = prefix
    tree = DecisionTree(
        feature=z[f"{p}tree__feature"], threshold=z[f"{p}tree__threshold"],
        left=z[f"{p}tree__left"], right=z[f"{p}tree__right"],
        value=z[f"{p}tree__value"],
        n_features=int(z[f"{p}tree__n_features"]),
        n_classes=int(z[f"{p}tree__n_classes"]),
    )
    table = RuleTable(
        comparator=z[f"{p}tbl__comparator"], th1=z[f"{p}tbl__th1"],
        th2=z[f"{p}tbl__th2"], classes=z[f"{p}tbl__classes"],
        n_classes=int(z[f"{p}tbl__n_classes"]),
    )
    n_th = int(z[f"{p}lut__n_thresholds"])
    lut = TernaryLUT(
        cells=z[f"{p}lut__cells"], classes=z[f"{p}lut__classes"],
        n_classes=int(z[f"{p}lut__n_classes"]),
        feat_offsets=z[f"{p}lut__feat_offsets"],
        thresholds=[z[f"{p}lut__th_{i}"] for i in range(n_th)],
    )
    s, n_rwd, n_cwd, n_rows, width, n_classes = (
        int(v) for v in z[f"{p}lay__dims"]
    )
    layout = TCAMLayout(
        cells=z[f"{p}lay__cells"], classes=z[f"{p}lay__classes"],
        class_bits=z[f"{p}lay__class_bits"], s=s, n_rwd=n_rwd, n_cwd=n_cwd,
        n_rows=n_rows, width=width, n_classes=n_classes,
    )
    return CompiledDT(tree=tree, table=table, lut=lut, layout=layout)
