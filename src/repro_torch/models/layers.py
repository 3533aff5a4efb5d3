"""Common layers: norms, RoPE, dense MLPs, initializers, and the
recompute-in-backward wrapper (``jax.checkpoint``'s counterpart).

Compute dtype is bf16 (params f32, cast at use); norms and softmax statistics
run in f32.  The gated MLP's GeGLU uses the tanh approximation of GELU, which
is what the JAX package's ``jax.nn.gelu`` computes by default.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

__all__ = [
    "rms_norm", "nonparam_norm", "rope", "rope_table", "mlp", "act_fn",
    "dense_init", "checkpointed", "REMAT", "COMPUTE_DTYPE",
]

REMAT = ("none", "dots", "full")


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of products
    without batch dimensions (``mm``/``addmm``), recompute the rest
    (``bmm`` included)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn, *args, remat: str = "full"):
    """``fn(*args)``, its activations recomputed in the backward instead of
    stored (``remat="full"``), or all but its ``mm`` outputs
    (``remat="dots"``); ``"none"``, or no gradient being recorded, is a
    plain call."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}; expected one of {REMAT}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

COMPUTE_DTYPE = torch.bfloat16


def dense_init(gen: torch.Generator, shape, in_axis: int = 0, *,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (std = 1/sqrt(fan_in)), f32, drawn from
    ``gen`` on its device.  ``out`` (f32, ``shape``) is filled in place."""
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(shape[in_axis] ** -0.5)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def nonparam_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale/bias)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables, f32, shape positions.shape + (head_dim//2,)."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), expo)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Apply rotary embedding; x: (..., seq, heads, head_dim); sin/cos:
    (..., seq, head_dim//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    s = sin[..., None, :].float()
    c = cos[..., None, :].float()
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


def act_fn(g: torch.Tensor, act: str) -> torch.Tensor:
    """SiLU, or GELU in its tanh approximation (``jax.nn.gelu``'s default)."""
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def mlp(x: torch.Tensor, p: dict, act: str, dot=None) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU): (w_gate, w_up) -> act(g) * u -> w_down.
    Sharded over its hidden dim, ``dot`` (``Shards.dot``) takes the
    product with ``w_down``'s rows and sums it over the ranks."""
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    hid = act_fn(g, act) * u
    w = p["w_down"].to(dt)
    return hid @ w if dot is None else dot(hid, w)
