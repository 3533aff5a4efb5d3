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

``forest_from_arrays`` rebuilds a ``CompiledForest`` from a forest's blob:
``f__n_banks``, ``f__n_features``, ``f__n_classes``, ``f__classes``,
``f__cast_f32`` and ``f__s``, then each bank's compiled tree under
``b{i}__`` with its soft-vote table ``b{i}__proba`` where it has one.  The
vote rule is not in the blob (the registry keeps it in its index), so the
caller names it.

``lm_params_from_arrays`` carries an LM's parameters across: it takes the
JAX package's param pytree as numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns the port's pytree of tensors on ``device``, with the
same nesting, values, dtypes (bfloat16 included) and stacked layout.

``train_state_from_arrays`` does the same for a whole train state (the JAX
package's ``TrainState`` as numpy arrays: params, AdamW moments and step,
and the EF residual or None), and ``train_state_to_arrays`` goes back: the
port's ``TrainState`` of numpy arrays, bf16 leaves as their raw ``int16``
words (the form the checkpoint writes; numpy has no bfloat16 of its own).

``to_numpy`` and ``from_numpy`` are the host conversions under all of
these and under the checkpoint manager.
"""
from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch

from .core.cart import DecisionTree
from .core.compiler import CompiledDT
from .core.lut import TernaryLUT
from .core.reduce import RuleTable
from .core.synth import TCAMLayout
from .device import DeviceLike, resolve_device
from .forest.compiler import CompiledForest, ForestBank
from .pytree import tree_map

__all__ = ["compiled_from_arrays", "forest_from_arrays",
           "lm_params_from_arrays", "train_state_from_arrays",
           "train_state_to_arrays", "to_numpy", "from_numpy"]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 as its raw words (``int16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A tensor on ``device`` from a host array; 2-byte void words (a
    ``'<V2'`` leaf) or numpy's bfloat16 extension type come back bf16."""
    a = np.require(a, requirements=("C", "W"))   # torch wants writable
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


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


def forest_from_arrays(z: Mapping[str, np.ndarray],
                       vote: str) -> CompiledForest:
    """Rebuild the compiled forest stored in ``z`` with vote rule ``vote``."""
    banks = [
        ForestBank(
            compiled=compiled_from_arrays(z, f"b{i}__"),
            proba=z[f"b{i}__proba"] if f"b{i}__proba" in z else None,
        )
        for i in range(int(z["f__n_banks"]))
    ]
    return CompiledForest(
        banks=banks,
        n_features=int(z["f__n_features"]),
        n_classes=int(z["f__n_classes"]),
        classes=z["f__classes"],
        vote=vote,
        cast_f32=bool(int(z["f__cast_f32"])),
        s=int(z["f__s"]),
    )


def lm_params_from_arrays(tree, *, device: DeviceLike = None, cfg=None,
                          rules=None):
    """The port's LM params from the JAX package's, given as numpy arrays
    in nested dicts; tensors on ``device`` (default: the card).  With
    ``rules`` over a ``DeviceMesh`` (and the model's ``cfg``), this rank's
    ``DTensor`` shards of them (``models.params.shard_params``)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return from_numpy(np.asarray(t), dev)   # never shares the buffer

    if rules is None:
        return conv(tree)
    from .models.params import shard_params
    return shard_params(conv(tree), cfg, rules)


def train_state_from_arrays(state, *, device: DeviceLike = None):
    """The port's ``TrainState`` from the JAX package's, given as numpy
    arrays (``jax.tree.map(np.asarray, state)``); tensors on ``device``
    (default: the card)."""
    from .optim import OptState
    from .train import TrainState
    dev = resolve_device(device)
    conv = functools.partial(lm_params_from_arrays, device=dev)
    return TrainState(
        params=conv(state.params),
        opt=OptState(mu=conv(state.opt.mu), nu=conv(state.opt.nu),
                     step=from_numpy(np.asarray(state.opt.step), dev)),
        ef=None if state.ef is None else conv(state.ef))


def train_state_to_arrays(state):
    """The port's ``TrainState`` with every leaf a host numpy array, bf16
    leaves as their raw ``int16`` words."""
    return tree_map(to_numpy, state)
