"""A cell at its files' ``test_sizes`` on the CPU: the tests' and the
rehearsals' way to drive a whole run without a card (the result's
``platform`` is then ``cpu``, and no number of it is a device number)."""
from __future__ import annotations

import copy
import time

import torch

from .harness import Ctx, load_cell

__all__ = ["shrink", "small_ctx"]


def shrink(conf: dict) -> dict:
    """``conf`` with its ``test_sizes`` in place (a ``replace`` entry
    extends ``run.replace``)."""
    out = copy.deepcopy(conf)
    sizes = dict(out.pop("test_sizes"))
    replace = sizes.pop("replace", None)
    out.update(sizes)
    if replace is not None:
        out["run"]["replace"] = {**out["run"].get("replace", {}), **replace}
    return out


def small_ctx(workload: str, seed: int, seconds: float = 0.0,
              trace: bool = False, variant: str | None = None) -> Ctx:
    manifest, cell, conf, traffic, limits = load_cell(workload)
    return Ctx(workload=workload, seed=seed, seconds=seconds, trace=trace,
               t0=time.perf_counter(), manifest=manifest, cell=cell,
               conf=shrink(conf), traffic=shrink(traffic),
               limits=shrink(limits),
               device=torch.device("cpu"), variant=variant, card="cpu")
