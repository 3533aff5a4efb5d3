"""Checkpoint manager: atomic, validated, retained; restores onto the
device of the state it is given.

Layout (one directory per step), the JAX package's byte for byte, so either
package restores what the other wrote::

    <dir>/step_000000042.tmp/...   # written first
    <dir>/step_000000042/          # atomic rename after fsync
        manifest.json              # step, leaf paths, shapes, dtypes, crc
        arr_00000.npy ...          # one file per leaf, jax.tree order

Leaves go in ``jax.tree.flatten``'s order (``pytree.tree_leaves``: dict
keys sorted, NamedTuple fields in order, ``None`` no leaf).  A bf16 leaf is
the JAX package's form: its raw 2-byte words in an ``.npy`` whose header
says ``'<V2'``, with manifest dtype ``"bfloat16"``; the port writes and
reads those words through an ``int16`` view (numpy has no bfloat16 of its
own).

A sharded state (``DTensor`` leaves over a mesh, from
``train.init_train_state(..., rules=)``) is saved whole: each leaf is
gathered on every rank and rank 0 writes the same files one process would.
Restoring onto a sharded ``state_like`` gives each rank its shards per that
leaf's mesh and placements, whatever mesh saved it (``restore_resharded``,
the elastic restart).

Failure semantics:
  * a crash mid-save leaves only a ``.tmp`` dir -> ignored and removed,
  * ``latest_step`` validates the manifest and every leaf file before
    declaring a checkpoint restorable; corrupt dirs are skipped (the
    previous step is used),
  * retention keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Optional

import numpy as np
import torch

from ..convert import from_numpy, to_numpy
from ..pytree import tree_leaves, tree_unflatten

__all__ = ["CheckpointManager", "restore_resharded"]

_BF16_DESCR = "<V2"      # what numpy writes for the JAX package's bfloat16


def _save_leaf(path: str, t: torch.Tensor) -> dict:
    arr = to_numpy(t)
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
            f.write(arr.tobytes())
        dtype = "bfloat16"
    else:
        np.save(path, arr)
        dtype = str(arr.dtype)
    return {"shape": list(arr.shape), "dtype": dtype,
            "crc": zlib.crc32(arr.tobytes())}


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------- save
    def save(self, step: int, state) -> str:
        """Write ``state`` as step ``step``; with ``DTensor`` leaves every
        rank gathers each leaf, rank 0 writes and the ranks meet at a
        barrier before returning."""
        leaves = tree_leaves(state)
        mesh = next((t.device_mesh for t in leaves if _is_dtensor(t)), None)
        writer = mesh is None or torch.distributed.get_rank() == 0
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, leaf in enumerate(leaves):
            if _is_dtensor(leaf):
                leaf = leaf.full_tensor()
            if not writer:
                continue
            path = f"arr_{i:05d}.npy"
            meta = _save_leaf(os.path.join(tmp, path), leaf)
            manifest["leaves"].append({"path": path, **meta})
        if not writer:
            torch.distributed.barrier()
            return final
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        if mesh is not None:
            torch.distributed.barrier()
        return final

    # -------------------------------------------------------- restore
    def _steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _valid(self, step: int) -> bool:
        d = os.path.join(self.dir, f"step_{step:09d}")
        mf = os.path.join(d, "manifest.json")
        if not os.path.exists(mf):
            return False
        try:
            with open(mf) as f:
                manifest = json.load(f)
            for leaf in manifest["leaves"]:
                arr = np.load(os.path.join(d, leaf["path"]), mmap_mode="r")
                if list(arr.shape) != leaf["shape"]:
                    return False
            return True
        except Exception:       # any unreadable file marks the dir corrupt
            return False

    def latest_step(self) -> Optional[int]:
        for step in reversed(self._steps()):
            if self._valid(step):
                return step
        return None

    def restore(self, state_like, step: Optional[int] = None,
                *, verify_crc: bool = False):
        """Restore into the structure of ``state_like``; each leaf goes to
        the device of ``state_like``'s leaf in its place, and a ``DTensor``
        leaf to this rank's shards of its mesh and placements.  Returns
        (state, step), or None when no checkpoint is restorable."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like = tree_leaves(state_like)
        if len(leaves_like) != len(manifest["leaves"]):
            raise ValueError("checkpoint/state structure mismatch")
        out = []
        for like, meta in zip(leaves_like, manifest["leaves"]):
            arr = np.load(os.path.join(d, meta["path"]))
            if verify_crc and zlib.crc32(arr.tobytes()) != meta["crc"]:
                raise IOError(f"crc mismatch in {meta['path']}")
            t = from_numpy(arr, getattr(like, "device", "cpu"))
            if _is_dtensor(like):
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(t, like.device_mesh, like.placements,
                                      src_data_rank=None)
            out.append(t)
        return tree_unflatten(state_like, out), step

    # ------------------------------------------------------ retention
    def _gc(self) -> None:
        steps = self._steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)


def restore_resharded(mgr: CheckpointManager, state_like):
    """Elastic restore: load the latest checkpoint onto ``state_like``'s
    devices and, for ``DTensor`` leaves, its meshes and placements; the
    mesh that saved it does not matter."""
    return mgr.restore(state_like)
