"""Gradient compression: per-tensor symmetric int8 quantization with error
feedback (EF / memory-compensated SGD).

Across hosts the quantize/dequantize pair would wrap the gradient
reduction (8x fewer bytes on the wire); the EF residual carries the
quantization error into the next step so convergence is preserved (Stich
et al., Karimireddy et al.).  On one card this is the algorithmic layer,
run by the train step's ``compress=True``.  ``torch.round`` rounds half to
even, as the reference's ``jnp.round`` does, so ``q`` is the reference's.
"""
from __future__ import annotations

import torch

from ..pytree import tree_leaves, tree_map, tree_unflatten

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress", "ef_init"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale f32 0-d)."""
    xf = x.float()
    # divide by a tensor on the device: CUDA turns ``tensor / float`` into a
    # product with the reciprocal, which can move q by one step
    scale = xf.abs().max() / torch.tensor(127.0, device=xf.device)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(params) -> dict:
    """Zero f32 residuals with the params' structure and devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress(grads, residual):
    """Error-feedback compression: g' = Q(g + r); r' = (g + r) - g'.
    Returns (compressed grads, new residual)."""
    def one(g, r):
        x = g.float() + r
        q, s = quantize_int8(x)
        d = dequantize_int8(q, s)
        return d, x - d

    pairs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                       tree_leaves(residual))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            tree_unflatten(residual, [p[1] for p in pairs]))
