"""Versioned model registry: content-hashed compiled layouts with lineage.

A production deployment retrains continuously; every artifact that can reach
a chip must be addressable, reproducible, and traceable to its parents.  The
registry stores *compiled* models (``CompiledDT`` / ``CompiledForest``) —
the unit the TCAM actually serves — as one ``.npz`` per version plus a JSON
index:

* **content addressing** — the version id is ``<name>:<sha256[:12]>`` over
  every array of the compiled artifact (cells, classes, thresholds, tree
  arrays, ...), so publishing the same compile twice is idempotent and two
  registries agree on identity without coordination;
* **lineage** — each version records its parent version ids (the model it
  was retrained/delta-programmed from) and free-form metadata;
  ``lineage()`` walks the ancestry;
* **round-trip** — ``load()`` reconstructs the full compiled object
  (tree + rule table + LUT + layout, and per-bank proba tables for forests)
  bit-exactly, through ``convert.compiled_from_arrays`` /
  ``convert.forest_from_arrays``; the lifecycle tests assert array equality
  and identical re-hash.

Blobs, index and version ids are those of the JAX package's registry: a
registry directory written by either package loads in the other.
Everything here is numpy-only.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from ..convert import compiled_from_arrays, forest_from_arrays
from ..core.cart import DecisionTree
from ..core.compiler import CompiledDT

__all__ = ["ModelVersion", "ModelRegistry", "content_hash"]

_INDEX = "index.json"


# ---------------------------------------------------------------------------
# serialization: compiled artifact -> flat dict of arrays (``convert``
# reads them back)
# ---------------------------------------------------------------------------

def _pack_tree(t: DecisionTree, p: str) -> dict:
    return {
        f"{p}feature": t.feature, f"{p}threshold": t.threshold,
        f"{p}left": t.left, f"{p}right": t.right, f"{p}value": t.value,
        f"{p}n_features": np.int64(t.n_features),
        f"{p}n_classes": np.int64(t.n_classes),
    }


def _pack_compiled(c: CompiledDT, p: str = "") -> dict:
    d = _pack_tree(c.tree, f"{p}tree__")
    tb = c.table
    d.update({
        f"{p}tbl__comparator": tb.comparator, f"{p}tbl__th1": tb.th1,
        f"{p}tbl__th2": tb.th2, f"{p}tbl__classes": tb.classes,
        f"{p}tbl__n_classes": np.int64(tb.n_classes),
    })
    lut = c.lut
    d.update({
        f"{p}lut__cells": lut.cells, f"{p}lut__classes": lut.classes,
        f"{p}lut__n_classes": np.int64(lut.n_classes),
        f"{p}lut__feat_offsets": lut.feat_offsets,
        f"{p}lut__n_thresholds": np.int64(len(lut.thresholds)),
    })
    for i, th in enumerate(lut.thresholds):
        d[f"{p}lut__th_{i}"] = th
    lay = c.layout
    d.update({
        f"{p}lay__cells": lay.cells, f"{p}lay__classes": lay.classes,
        f"{p}lay__class_bits": lay.class_bits,
        f"{p}lay__dims": np.asarray(
            [lay.s, lay.n_rwd, lay.n_cwd, lay.n_rows, lay.width,
             lay.n_classes], np.int64),
    })
    return d


def _pack_forest(forest) -> dict:
    d: dict = {
        "f__n_banks": np.int64(forest.n_banks),
        "f__n_features": np.int64(forest.n_features),
        "f__n_classes": np.int64(forest.n_classes),
        "f__classes": np.asarray(forest.classes),
        "f__cast_f32": np.int64(int(forest.cast_f32)),
        "f__s": np.int64(forest.s),
    }
    for i, bank in enumerate(forest.banks):
        d.update(_pack_compiled(bank.compiled, f"b{i}__"))
        if bank.proba is not None:
            d[f"b{i}__proba"] = bank.proba
    return d


def content_hash(compiled) -> str:
    """sha256 over every array of the compiled artifact, in sorted key
    order with dtype+shape framing — identical compiles hash identically
    regardless of process or platform."""
    packed = (_pack_forest(compiled) if hasattr(compiled, "banks")
              else _pack_compiled(compiled))
    h = hashlib.sha256()
    for key in sorted(packed):
        a = np.ascontiguousarray(np.asarray(packed[key]))
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(np.asarray(a.shape, np.int64).tobytes())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """One published model version (the index entry, JSON-shaped)."""

    version_id: str               # "<name>:<hash12>"
    name: str
    kind: str                     # 'tree' | 'forest'
    content_hash: str             # full sha256
    parents: tuple[str, ...]      # parent version ids (lineage)
    created: str                  # ISO timestamp (informational only)
    metadata: dict
    n_features: int
    n_classes: int
    s: int
    lut_shape: tuple[int, int]    # rows, width (summed over banks)
    n_banks: int
    seq: int = 0                  # monotonic publication order

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["parents"] = list(self.parents)
        d["lut_shape"] = list(self.lut_shape)
        return d

    @staticmethod
    def from_json(d: dict) -> "ModelVersion":
        return ModelVersion(
            version_id=d["version_id"], name=d["name"], kind=d["kind"],
            content_hash=d["content_hash"], parents=tuple(d["parents"]),
            created=d["created"], metadata=d.get("metadata", {}),
            n_features=int(d["n_features"]), n_classes=int(d["n_classes"]),
            s=int(d["s"]), lut_shape=tuple(d["lut_shape"]),
            n_banks=int(d["n_banks"]), seq=int(d.get("seq", 0)),
        )


class ModelRegistry:
    """File-backed versioned registry of compiled models.

    >>> reg = ModelRegistry("artifacts/registry")
    >>> v1 = reg.publish(compiled_v1, "traffic")
    >>> v2 = reg.publish(compiled_v2, "traffic", parents=[v1.version_id])
    >>> live = reg.load(reg.latest("traffic").version_id)
    """

    def __init__(self, root: str) -> None:
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._index: dict[str, ModelVersion] = {}
        self._load_index()

    # -- index persistence --------------------------------------------------
    def _index_path(self) -> str:
        return os.path.join(self.root, _INDEX)

    def _load_index(self) -> None:
        path = self._index_path()
        if not os.path.exists(path):
            return
        with open(path) as f:
            raw = json.load(f)
        self._index = {
            vid: ModelVersion.from_json(meta)
            for vid, meta in raw.get("versions", {}).items()
        }

    def _save_index(self) -> None:
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"versions": {vid: v.to_json()
                              for vid, v in sorted(self._index.items())}},
                f, indent=2,
            )
        os.replace(tmp, self._index_path())

    def _blob_path(self, version_id: str) -> str:
        return os.path.join(self.root, version_id.replace(":", "__") + ".npz")

    # -- publish / load -----------------------------------------------------
    def publish(
        self,
        compiled,
        name: str,
        *,
        parents: Sequence[str] = (),
        metadata: Optional[dict] = None,
    ) -> ModelVersion:
        """Store a compiled model; returns its (possibly pre-existing)
        version.  Idempotent: identical content under the same name maps to
        the same version id and is not re-written."""
        if ":" in name or "/" in name:
            raise ValueError(f"model name {name!r} may not contain ':' or '/'")
        for p in parents:
            if p not in self._index:
                raise KeyError(f"parent version {p!r} not in registry")
        is_forest = hasattr(compiled, "banks")
        chash = content_hash(compiled)
        vid = f"{name}:{chash[:12]}"
        if vid in self._index:
            return self._index[vid]
        packed = _pack_forest(compiled) if is_forest \
            else _pack_compiled(compiled)
        np.savez_compressed(self._blob_path(vid), **packed)
        if is_forest:
            kind, n_banks = "forest", compiled.n_banks
            n_features, n_classes, s = (compiled.n_features,
                                        compiled.n_classes, compiled.s)
            lut_shape = (sum(b.lut.n_rows for b in compiled.banks),
                         max(b.lut.width for b in compiled.banks))
            metadata = dict(metadata or {})
            metadata.setdefault("vote", compiled.vote)
        else:
            kind, n_banks = "tree", 1
            n_features = compiled.tree.n_features
            n_classes = compiled.tree.n_classes
            s = compiled.layout.s
            lut_shape = compiled.lut_shape
            metadata = dict(metadata or {})
        version = ModelVersion(
            version_id=vid, name=name, kind=kind, content_hash=chash,
            parents=tuple(parents),
            created=time.strftime("%Y-%m-%dT%H:%M:%S"),
            metadata=metadata, n_features=int(n_features),
            n_classes=int(n_classes), s=int(s),
            lut_shape=(int(lut_shape[0]), int(lut_shape[1])),
            n_banks=int(n_banks),
            seq=1 + max((v.seq for v in self._index.values()), default=0),
        )
        self._index[vid] = version
        self._save_index()
        return version

    def load(self, version_id: str):
        """Reconstruct the compiled model of a version (round-trip exact)."""
        v = self.get(version_id)
        with np.load(self._blob_path(v.version_id)) as z:
            if v.kind == "forest":
                return forest_from_arrays(z, v.metadata.get("vote", "hard"))
            return compiled_from_arrays(z)

    # -- queries ------------------------------------------------------------
    def get(self, version_id: str) -> ModelVersion:
        if version_id not in self._index:
            raise KeyError(f"unknown version {version_id!r}")
        return self._index[version_id]

    def versions(self, name: Optional[str] = None) -> list[ModelVersion]:
        """All versions (of one model name, if given), oldest-published
        first.  Ordered by publication sequence, not index-file key order —
        the persisted index is key-sorted for diff stability."""
        out = [v for v in self._index.values()
               if name is None or v.name == name]
        out.sort(key=lambda v: v.seq)
        return out

    def latest(self, name: str) -> ModelVersion:
        vs = self.versions(name)
        if not vs:
            raise KeyError(f"no versions published under {name!r}")
        return vs[-1]

    def lineage(self, version_id: str) -> list[ModelVersion]:
        """Ancestry walk: the version, its first parent, that parent's
        first parent, ... oldest last."""
        out = []
        seen = set()
        vid: Optional[str] = version_id
        while vid is not None and vid not in seen:
            seen.add(vid)
            v = self.get(vid)
            out.append(v)
            vid = v.parents[0] if v.parents else None
        return out

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, version_id: str) -> bool:
        return version_id in self._index
