"""Plain AdamW with decoupled weight decay on every leaf, clipping by the
global gradient norm, a linear warm-up and a cosine schedule (Loshchilov
and Hutter; the configuration file's ``run.optimizer`` numbers), float32.
"""
from __future__ import annotations

import math

import torch

__all__ = ["lr_at", "adamw_step"]


def lr_at(o: dict, t: int) -> float:
    """The learning rate of step ``t`` (1-based)."""
    if t < o["warmup_steps"]:
        return o["lr"] * t / max(o["warmup_steps"], 1)
    prog = min(max((t - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    frac = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return o["lr"] * frac


@torch.no_grad()
def adamw_step(o: dict, t: int, params: list, grads: list, m: list,
               v: list) -> list:
    """Step ``t`` in place on ``params`` (and the moments ``m``, ``v``);
    returns each leaf's gradient as the update used it (clipped)."""
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    scale = min(1.0, o["clip_norm"] / max(float(gnorm), 1e-9))
    lr = lr_at(o, t)
    used = []
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * scale
        used.append(g)
        mi.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
        vi.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
        mh = mi / (1 - o["b1"] ** t)
        vh = vi / (1 - o["b2"] ** t)
        p.sub_(lr * (mh / (vh.sqrt() + o["eps"]) + o["weight_decay"] * p))
    return used
