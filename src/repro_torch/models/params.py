"""Parameter pytree construction + logical sharding axes.

Every leaf is described once in a *leaf spec* ``(shape, logical_axes, init)``
so the init pytree and the logical-axis pytree can never drift apart.
Stacked layer leaves get a leading ``total_occurrences`` dim (logical name
"layers") and are consumed by the layer loop in ``lm.py``.  The pytree is
the JAX package's, leaf for leaf, so ``convert.lm_params_from_arrays``
carries its weights across; the init draws from its own generator and need
not agree with the JAX package's.

The mamba, rwkv and channel-mix leaves and the encoder-decoder's belong to
parts that are not ported yet: asking for them raises
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import dense_init

__all__ = ["init_params", "param_logical_axes", "param_count", "kind_specs",
           "not_ported"]

Init = Union[str, Callable]

# what each mixer that is not ported yet waits for, by ROADMAP item
_LATER = {
    "mamba": "the mamba mixer (jamba) is not ported yet: ROADMAP Queue A 1",
    "rwkv": "the rwkv mixer (rwkv6) is not ported yet: ROADMAP Queue A 2",
    "cmix": "the rwkv channel mix (rwkv6) is not ported yet: ROADMAP Queue A 2",
    "encdec": ("the encoder-decoder (whisper) is not ported yet: "
               "ROADMAP Queue A 3"),
}


def not_ported(part: str) -> NotImplementedError:
    """The error for a model part that a later slice of the port brings."""
    return NotImplementedError(_LATER[part])


def _fill(gen: torch.Generator, out: torch.Tensor, init: Init) -> None:
    """Fill the f32 leaf ``out`` in place per its init (a callable init
    fills it itself)."""
    if callable(init):
        init(gen, out)
    elif init == "zeros":
        out.zero_()
    elif init == "ones":
        out.fill_(1.0)
    elif init.startswith("dense"):
        dense_init(gen, tuple(out.shape), in_axis=int(init[5:] or 0), out=out)
    else:
        raise ValueError(init)


def _normal(scale: float) -> Callable:
    def init(gen: torch.Generator, out: torch.Tensor) -> None:
        out.normal_(generator=gen).mul_(scale)
    return init


# ---------------------------------------------------------------------------
# leaf specs per layer kind: name -> (shape, logical axes, init)
# ---------------------------------------------------------------------------
def _attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "norm1": ((d,), (None,), "zeros"),
        "wq": ((d, h * hd), ("embed", "qkv"), "dense0"),
        "wk": ((d, kv * hd), ("embed", "qkv"), "dense0"),
        "wv": ((d, kv * hd), ("embed", "qkv"), "dense0"),
        "wo": ((h * hd, d), ("qkv", "embed"), "dense0"),
    }
    if cfg.qk_norm:
        out["q_norm"] = ((hd,), (None,), "zeros")
        out["k_norm"] = ((hd,), (None,), "zeros")
    return out


def _mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm2": ((d,), (None,), "zeros"),
        "w_gate": ((d, f), ("embed", "mlp"), "dense0"),
        "w_up": ((d, f), ("embed", "mlp"), "dense0"),
        "w_down": ((f, d), ("mlp", "embed"), "dense0"),
    }


def _moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.expert_ff, cfg.n_experts
    return {
        "norm2": ((d,), (None,), "zeros"),
        "w_router": ((d, e), ("embed", "experts"), "dense0"),
        "w_gate": ((e, d, f), ("experts", "embed", None), "dense1"),
        "w_up": ((e, d, f), ("experts", "embed", None), "dense1"),
        "w_down": ((e, f, d), ("experts", None, "embed"), "dense1"),
    }


def _mamba_specs(cfg: ModelConfig) -> dict:
    raise not_ported("mamba")


def _rwkv_specs(cfg: ModelConfig) -> dict:
    raise not_ported("rwkv")


def _cmix_specs(cfg: ModelConfig) -> dict:
    raise not_ported("cmix")


_MIXERS = {"attn": _attn_specs, "swa": _attn_specs, "mamba": _mamba_specs,
           "rwkv": _rwkv_specs}
_FFNS = {"mlp": _mlp_specs, "moe": _moe_specs, "cmix": _cmix_specs}


def kind_specs(cfg: ModelConfig, kind: str) -> dict:
    mixer, ffn = kind.split("+")
    return {**_MIXERS[mixer](cfg), **_FFNS[ffn](cfg)}


def _build(cfg: ModelConfig, gen: torch.Generator | None, *,
           axes_only: bool) -> dict:
    if cfg.is_encdec:
        raise not_ported("encdec")

    def leaf(shape, axes, init, stack: int = 0):
        full_axes = (("layers",) + tuple(axes)) if stack else tuple(axes)
        if axes_only:
            return full_axes
        # stacked leaves are allocated once and filled slice by slice, so the
        # largest leaf never exists twice on the device
        out = torch.empty(((stack,) if stack else ()) + tuple(shape),
                          dtype=torch.float32, device=gen.device)
        for sl in (out if stack else (out,)):
            _fill(gen, sl, init)
        return out

    d, v = cfg.d_model, cfg.vocab_size
    out: dict = {
        "embed": leaf((v, d), ("vocab", "embed"), _normal(0.02)),
        "final_norm": leaf((d,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = leaf((d, v), ("embed", "vocab"), "dense0")

    blocks = {}
    for kind in cfg.kinds:
        occ = len(cfg.kind_positions(kind)) * cfg.n_repeat
        specs = kind_specs(cfg, kind)
        blocks[kind] = {
            name: leaf(shape, axes, init, stack=occ)
            for name, (shape, axes, init) in specs.items()
        }
    out["blocks"] = blocks
    return out


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None) -> dict:
    """The f32 parameter pytree on ``device`` (default: the card), drawn from
    a ``torch.Generator`` on that device seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _build(cfg, gen, axes_only=False)


def param_logical_axes(cfg: ModelConfig) -> dict:
    return _build(cfg, None, axes_only=True)


def param_count(params) -> int:
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            yield t
    return int(sum(math.prod(x.shape) for x in leaves(params)))
