"""Parameter pytree construction + logical sharding axes.

Every leaf is described once in a *leaf spec* ``(shape, logical_axes, init)``
so the init pytree and the logical-axis pytree can never drift apart.
Stacked layer leaves get a leading ``total_occurrences`` dim (logical name
"layers") and are consumed by the layer loop in ``lm.py``.  The pytree is
the JAX package's, leaf for leaf, so ``convert.lm_params_from_arrays``
carries its weights across; the random inits draw from its own generator
and need not agree with the JAX package's, while the deterministic ones
(mamba's ``A_log``, rwkv's ``w_base`` and token-shift mixes) are copied
exactly.  An encoder-decoder adds the encoder's stack, its final norm and
positional table, and the decoder's positional table.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import dense_init

__all__ = ["init_params", "param_logical_axes", "param_count", "kind_specs",
           "param_shapes", "param_placements", "shard_params"]

Init = Union[str, Callable]


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


def _const(value: float) -> Callable:
    def init(gen: torch.Generator, out: torch.Tensor) -> None:
        out.fill_(value)
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
    d, di, n, k, r = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
                      cfg.dt_rank)

    def a_log_init(gen, out):
        out.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                         device=out.device)).expand(di, n))

    def dt_b_init(gen, out):
        # inverse-softplus of dt, log-uniform on [1e-3, 1e-1]
        dt = torch.exp(
            out.uniform_(generator=gen) * (math.log(0.1) - math.log(1e-3))
            + math.log(1e-3))
        out.copy_(dt + torch.log(-torch.expm1(-dt)))

    return {
        "norm1": ((d,), (None,), "zeros"),
        "in_proj": ((d, 2 * di), ("embed", "dinner"), "dense0"),
        "conv_w": ((di, k), ("dinner", None), "dense1"),
        "conv_b": ((di,), ("dinner",), "zeros"),
        "x_proj": ((di, r + 2 * n), ("dinner", None), "dense0"),
        "dt_w": ((r, di), (None, "dinner"), "dense0"),
        "dt_b": ((di,), ("dinner",), dt_b_init),
        "A_log": ((di, n), ("dinner", None), a_log_init),
        "Dskip": ((di,), ("dinner",), "ones"),
        "out_proj": ((di, d), ("dinner", "embed"), "dense0"),
    }


def _rwkv_specs(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    lora = 64

    def w_base_init(gen, out):
        # per-channel decay spread: exp(-exp(w)) from ~0.37 to ~0.999
        out.copy_(torch.linspace(-6.0, 1.0, d, device=out.device))

    return {
        "norm1": ((d,), (None,), "zeros"),
        "mu": ((5, d), (None, None), _const(0.5)),
        "w_base": ((d,), (None,), w_base_init),
        "w_lora_a": ((d, lora), ("embed", None), "dense0"),
        "w_lora_b": ((lora, d), (None, "embed"), "zeros"),
        "wr": ((d, d), ("embed", "qkv"), "dense0"),
        "wk": ((d, d), ("embed", "qkv"), "dense0"),
        "wv": ((d, d), ("embed", "qkv"), "dense0"),
        "wg": ((d, d), ("embed", "qkv"), "dense0"),
        "u": ((h, hd), (None, None), _normal(0.5)),
        "ln_x": ((d,), (None,), "zeros"),
        "wo": ((d, d), ("qkv", "embed"), "dense0"),
    }


def _cmix_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm2": ((d,), (None,), "zeros"),
        "cm_mu": ((2, d), (None, None), _const(0.5)),
        "cm_k": ((d, f), ("embed", "mlp"), "dense0"),
        "cm_v": ((f, d), ("mlp", "embed"), "dense0"),
        "cm_r": ((d, d), ("embed", "qkv"), "dense0"),
    }


def _cross_specs(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "norm_x": ((d,), (None,), "zeros"),
        "xwq": ((d, h * hd), ("embed", "qkv"), "dense0"),
        "xwk": ((d, h * hd), ("embed", "qkv"), "dense0"),
        "xwv": ((d, h * hd), ("embed", "qkv"), "dense0"),
        "xwo": ((h * hd, d), ("qkv", "embed"), "dense0"),
    }


_MIXERS = {"attn": _attn_specs, "swa": _attn_specs, "mamba": _mamba_specs,
           "rwkv": _rwkv_specs}
_FFNS = {"mlp": _mlp_specs, "moe": _moe_specs, "cmix": _cmix_specs}


def kind_specs(cfg: ModelConfig, kind: str, with_cross: bool = False) -> dict:
    mixer, ffn = kind.split("+")
    cross = _cross_specs(cfg) if with_cross else {}
    return {**_MIXERS[mixer](cfg), **cross, **_FFNS[ffn](cfg)}


def _build(cfg: ModelConfig, gen: torch.Generator | None, *,
           axes_only: bool) -> dict:
    """The leaves' logical axes (``axes_only``), their f32 shapes on the
    meta device (``gen`` None: nothing allocated), or the leaves drawn from
    ``gen`` on its device."""
    def leaf(shape, axes, init, stack: int = 0):
        full_axes = (("layers",) + tuple(axes)) if stack else tuple(axes)
        if axes_only:
            return full_axes
        # stacked leaves are allocated once and filled slice by slice, so the
        # largest leaf never exists twice on the device
        out = torch.empty(((stack,) if stack else ()) + tuple(shape),
                          dtype=torch.float32,
                          device="meta" if gen is None else gen.device)
        if gen is not None:
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
        specs = kind_specs(cfg, kind, with_cross=cfg.is_encdec)
        blocks[kind] = {
            name: leaf(shape, axes, init, stack=occ)
            for name, (shape, axes, init) in specs.items()
        }
    out["blocks"] = blocks

    if cfg.is_encdec:
        enc_specs = kind_specs(cfg, "attn+mlp")
        enc_blocks = {
            name: leaf(shape, axes, init, stack=cfg.encoder_layers)
            for name, (shape, axes, init) in enc_specs.items()
        }
        out["encoder"] = {
            "blocks": {"attn+mlp": enc_blocks},
            "final_norm": leaf((d,), (None,), "zeros"),
            "pos_emb": leaf((cfg.encoder_seq, d), (None, None), _normal(0.02)),
        }
        out["dec_pos_emb"] = leaf((32768, d), (None, None), _normal(0.02))
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


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter pytree as f32 tensors on the meta device: shapes and
    dtypes, no memory (the reference's ``jax.eval_shape(init_params)``)."""
    return _build(cfg, None, axes_only=False)


def _map_axes(fn, axes, tree):
    """``fn(logical_axes, leaf)`` over a dict tree whose axes tree holds a
    tuple of logical names in each leaf's place."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, axes[k], tree[k]) for k in tree}
    return fn(axes, tree)


def param_placements(cfg: ModelConfig, rules, params) -> dict:
    """Each leaf's ``DTensor`` placements under ``rules``."""
    return _map_axes(lambda ax, p: rules.placements(ax, p.shape),
                     param_logical_axes(cfg), params)


def shard_params(params, cfg: ModelConfig, rules) -> dict:
    """A whole param tree (every rank holds it) as ``DTensor``s laid out by
    the rules (``rules.mesh`` a ``DeviceMesh``): each rank keeps its shard
    of each leaf, a copy where the shard is smaller than the leaf and the
    leaf itself where it is the whole (a mesh of one copies nothing)."""
    from ..sharding.collectives import as_dtensor

    def put(ax, t):
        spec = rules.spec(ax, t.shape)
        local = t
        for i, axis in enumerate(spec):
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is None or rules.sizes[a] == 1:
                    continue
                n = local.shape[i] // rules.sizes[a]
                local = local.narrow(i, rules.mesh.get_local_rank(a) * n, n)
        if local.shape != t.shape:
            local = local.clone(memory_format=torch.contiguous_format)
        return as_dtensor(local, rules, ax, tuple(t.shape))

    return _map_axes(put, param_logical_axes(cfg), params)


def param_count(params) -> int:
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            yield t
    return int(sum(math.prod(x.shape) for x in leaves(params)))
