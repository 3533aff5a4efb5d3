"""Faults planted underneath the timed path, for calibration and the
tests: the program broken in one place, so that ``correct`` has to come
out false."""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

__all__ = ["half_batch", "one_rank_partial", "FAULTS"]


@contextlib.contextmanager
def half_batch():
    """The train step's gradient over the first half of each batch's
    rows only (the mean over those)."""
    from repro_torch.train import step as step_mod
    whole = step_mod.accumulate_grads

    def half(cfg, params, batch, **kw):
        n = next(iter(batch.values())).shape[0] // 2
        return whole(cfg, params, {k: v[:n] for k, v in batch.items()}, **kw)
    with mock.patch.object(step_mod, "accumulate_grads", half):
        yield


@contextlib.contextmanager
def one_rank_partial(model_rank: int = 1):
    """The experts' combine summed over "model" without one rank's
    partial: that rank's experts' part of every MoE layer's output is
    zero when it enters the all-reduce."""
    from repro_torch.models import moe
    whole = moe._moe_groups

    def broken(xt, p, cfg, router_bits, w, shards, *args, **kw):
        y = whole(xt, p, cfg, router_bits, w, shards, *args, **kw)
        split = p["w_gate"].shape[0] < cfg.n_experts
        if split and shards.rank("model") == model_rank:
            return torch.zeros_like(y)
        return y
    with mock.patch.object(moe, "_moe_groups", broken):
        yield


FAULTS = {"half": half_batch, "rank_partial": one_rank_partial}
