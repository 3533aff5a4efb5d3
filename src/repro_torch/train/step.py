"""Step builders: the train step (value and gradient through autograd,
microbatch gradient accumulation, remat policies, optional int8+EF gradient
compression, AdamW) and the prefill / decode steps.

A step is a function of its inputs, as the reference's jitted step is: it
returns a new state and leaves the one it was given untouched, so a caller
that retries from the state it holds (``runtime.FaultTolerantLoop``) never
sees one half-updated.  On one card there is no sharding, so the builders
take no mesh rules, and the reference's sharding-only functions
(``state_shardings``, ``input_specs``, ``cache_logical_axes``) have no
counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import DeviceLike
from ..models import ModelConfig, decode_step, init_params, loss_fn, prefill
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..optim.compress import ef_compress, ef_init
from ..pytree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "TrainState", "init_train_state", "build_train_step",
    "build_prefill_step", "build_decode_step", "accumulate_grads",
]


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    ef: Optional[dict]      # error-feedback residual (compression) or None


def init_train_state(cfg: ModelConfig, seed: int = 0, *,
                     compress: bool = False,
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     device: DeviceLike = None) -> TrainState:
    """Fresh params from ``seed``, zero moments and step 0 on ``device``
    (default: the card); an EF residual too with ``compress``."""
    params = init_params(cfg, seed, device=device)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg),
                      ef=ef_init(params) if compress else None)


def _value_and_grad(cfg: ModelConfig, params, batch, remat: str):
    """loss_fn's (loss, metrics) and its gradient for every param leaf (zeros
    for a leaf the loss does not use), all detached."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), cfg, batch,
                                remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def accumulate_grads(cfg: ModelConfig, params, batch, *, accum: int = 1,
                     remat: str = "full",
                     accum_dtype: torch.dtype = torch.float32):
    """The step's gradient and metrics: one pass over ``batch``, or with
    ``accum > 1`` its ``accum`` microbatches (split on the batch axis) in
    turn, the gradients summed in ``accum_dtype`` and averaged, as the
    reference's scanned accumulation.  Returns (grads, metrics): ``loss``,
    and ``tokens`` with ``accum == 1`` only, as there."""
    if accum == 1:
        loss, metrics, grads = _value_and_grad(cfg, params, batch, remat)
        return grads, metrics
    n = next(iter(batch.values())).shape[0]
    if n % accum:
        raise ValueError(f"batch {n} does not split into {accum} "
                         "microbatches")
    m = n // accum
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                           device=p.device), params)
    l_acc = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(params)[0].device)
    for i in range(accum):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        loss, _, g = _value_and_grad(cfg, params, mb, remat)
        g_acc = tree_map(lambda a, b: a + b.to(a.dtype), g_acc, g)
        l_acc = l_acc + loss
    grads = tree_map(lambda g: g / torch.tensor(accum, dtype=g.dtype,
                                                device=g.device), g_acc)
    return grads, {"loss": l_acc / torch.tensor(accum, dtype=torch.float32,
                                                device=l_acc.device)}


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    *,
    accum: int = 1,
    compress: bool = False,
    remat: str = "full",
    accum_dtype: torch.dtype = torch.float32,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is a dict of arrays or tensors (``tokens``, ``labels`` and, per
    configuration, ``patches`` or ``frames``), moved to the state's device.
    ``accum > 1`` splits it into microbatches run in turn; ``accum_dtype``
    holds their summed gradients.  Metrics (0-d tensors on the device):
    ``loss``, ``tokens`` (accum 1 only), ``grad_norm`` and ``lr``."""

    def train_step(state: TrainState, batch):
        dev = state.opt.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        grads, metrics = accumulate_grads(cfg, state.params, batch,
                                          accum=accum, remat=remat,
                                          accum_dtype=accum_dtype)
        ef = state.ef
        if compress:
            grads, ef = ef_compress(grads, ef)
        params, opt, m2 = adamw_update(grads, state.opt, state.params,
                                       opt_cfg)
        return TrainState(params=params, opt=opt, ef=ef), dict(metrics, **m2)

    return train_step


def build_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, caches):
        return prefill(params, cfg, batch["tokens"], caches,
                       frontend=batch.get("patches"),
                       frames=batch.get("frames"))
    return prefill_step


def build_decode_step(cfg: ModelConfig):
    def serve_step(params, token, caches, pos):
        return decode_step(params, cfg, token, caches, pos)
    return serve_step
