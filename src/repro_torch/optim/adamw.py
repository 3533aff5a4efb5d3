"""AdamW with decoupled weight decay, global-norm clipping and a cosine LR
schedule, on nested dicts of tensors.  Moments have the params' structure
(f32 by default; ``mu_dtype``/``nu_dtype`` may make them bf16).

The arithmetic is the reference's, in f32 and in its order: clip scale,
bias corrections, then ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``
and a cast back to each leaf's dtype (``torch.optim.AdamW`` orders the decay
differently).  Scalars (step, lr, clip scale, corrections) stay 0-d tensors
on the params' device, so an update reads nothing back to the host, and
every quotient divides by a tensor there (CUDA turns ``tensor / float``
into a product with the reciprocal, one rounding off the reference).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..pytree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # memory policy: a bf16 first moment halves the optimizer's memory
    mu_dtype: str = "float32"
    nu_dtype: str = "float32"


class OptState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor          # 0-d int32 on the params' device


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> OptState:
    """Zero moments in ``cfg``'s dtypes and step 0, on the params' device."""
    def zeros(name):
        dt = getattr(torch, name)
        return tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                              device=p.device), params)
    dev = tree_leaves(params)[0].device
    return OptState(mu=zeros(cfg.mu_dtype), nu=zeros(cfg.nu_dtype),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``; f32 0-d on step's device."""
    s = step.float()
    warm = s / _f32(max(cfg.warmup_steps, 1), s)
    prog = torch.clamp(
        (s - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi, s) * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _release(tree) -> None:
    """Every leaf of a dict tree replaced by ``None``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _release(v)
        else:
            tree[k] = None


def adamw_update(grads, state: OptState, params, cfg: AdamWConfig, *,
                 donate_grads: bool = False):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}); the
    inputs are left as they were.  With ``donate_grads`` the caller gives
    up ``grads``: its leaves are taken out of the tree (replaced by
    ``None``) and each is freed once its leaf is updated, so the
    gradients do not all live beside the old and the new state.  A leaf's
    temporaries are updated in place, with the reference's operations in
    its order, so at most a few leaf-sized temporaries live at once."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(
        _f32(cfg.clip_norm, gnorm) / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    sf = step.float()
    b1c = 1 - torch.pow(_f32(cfg.b1, sf), sf)
    b2c = 1 - torch.pow(_f32(cfg.b2, sf), sf)

    def upd(p, g, m, v):
        g = g.float() * scale
        mf = cfg.b1 * m.float()
        mf.add_((1 - cfg.b1) * g)                 # b1 m + (1 - b1) g
        vf = cfg.b2 * v.float()
        gg = (1 - cfg.b2) * g
        vf.add_(gg.mul_(g))                       # b2 v + (1 - b2) g g
        del g, gg
        u = mf / b1c                              # mhat
        den = vf / b2c                            # vhat
        u.div_(den.sqrt_().add_(cfg.eps))         # mhat / (sqrt + eps)
        del den
        pf = p.float()
        u.add_(cfg.weight_decay * pf).mul_(lr)    # lr * (... + wd p)
        return (pf - u).to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    g_leaves = tree_leaves(grads)
    if donate_grads:
        _release(grads)
    trip = []
    for i, (p, m, v) in enumerate(zip(tree_leaves(params),
                                      tree_leaves(state.mu),
                                      tree_leaves(state.nu))):
        g = g_leaves[i]
        if donate_grads:
            g_leaves[i] = None
        trip.append(upd(p, g, m, v))
        del g
    new_p, new_mu, new_nu = (
        tree_unflatten(tree, [t[i] for t in trip])
        for i, tree in enumerate((params, state.mu, state.nu)))
    return new_p, OptState(new_mu, new_nu, step), {"grad_norm": gnorm,
                                                   "lr": lr}
