"""Mixture-of-Experts FFN: top-k routing with capacity-bounded scatter/gather
dispatch (no giant one-hot dispatch einsums).

Dispatch: tokens are ranked within their chosen expert by a stable sort;
tokens beyond an expert's capacity ``C = ceil(cf * T * k / E)`` (rounded up
to a multiple of 8) are dropped (standard GShard/Switch semantics).  The
(E, C, D) expert buffer is the only materialized dispatch structure:
bytes = E*C*D ~= cf * k * tokens * d_model, independent of E.

Token groups (``cfg.moe_groups``, GShard style) route, dispatch and compute
one group at a time, each with its own capacity, and are recomputed one at a
time in the backward.  Serving casts the expert weights to the compute dtype
once per layer call and shares them across groups.  Gradients reach the
router only through the top-k gates that were gathered; a dispatch dropped
over capacity gets none.

``router="tcam_dt"``: routing decisions come from a decision tree compiled to
a ternary LUT by the paper's DT-HW compiler and evaluated as a ternary match
— see ``tcam_router.py``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import act_fn, checkpointed

__all__ = ["moe_ffn", "capacity", "route"]

_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.experts_per_token
            / cfg.n_experts + 0.999)
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def _positions_in_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each dispatch within its expert (stable, order-preserving).

    Equivalent to grouping by expert and numbering arrivals; computed with a
    stable sort + inverse permutation (O(n log n), no (T, E) one-hot)."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # index_add_, not bincount: bincount on the card reads its input's
    # maximum back to the host, a sync in every group of every layer
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=flat_e.device).index_add_(
                             0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=flat_e.device) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def route(xt: torch.Tensor, p: dict, cfg: ModelConfig,
          router_bits: dict | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, D) tokens -> (top_w (T, k) f32, top_i (T, k) int64) expert
    choices; k is 1 for the TCAM router."""
    if cfg.router == "tcam_dt":
        from .tcam_router import route_tcam
        assert router_bits is not None, "tcam_dt router needs compiled bits"
        top_i = route_tcam(xt, router_bits)[:, None]         # (T, 1) top-1
        return torch.ones(top_i.shape, dtype=torch.float32,
                          device=xt.device), top_i
    logits = xt.float() @ p["w_router"].float()
    gates = torch.softmax(logits, dim=-1)
    # Sorted descending, as jax.lax.top_k.  On equal gates lax.top_k takes
    # the lower index first; torch.topk does not promise an order among
    # ties.  With f32 gates from real-valued logits a tie is unlikely.
    top_w, top_i = torch.topk(gates, cfg.experts_per_token, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(dim=-1, keepdim=True), 1e-9)
    return top_w, top_i


def moe_ffn(
    x: torch.Tensor,              # (B, S, D)
    p: dict,                      # w_router (D,E), w_gate/w_up (E,D,F), w_down (E,F,D)
    cfg: ModelConfig,
    *,
    router_bits: dict | None = None,   # tcam_dt router tensors (see tcam_router)
) -> torch.Tensor:
    b, s, d = x.shape
    t = b * s
    g = cfg.moe_groups if (b * s) % cfg.moe_groups == 0 else 1  # decode: t=B
    dt = x.dtype
    # Serving casts the expert weights once per layer call, shared by every
    # group.  With a gradient each group casts its own (inside its
    # checkpoint), so the f32 leaves collect the groups' gradients in f32,
    # as the reference's per-group cast does.
    w = (None if torch.is_grad_enabled() else
         {n: p[n].to(dt) for n in _EXPERT_WEIGHTS})
    xg = x.reshape(g, t // g, d)
    # with groups, each is recomputed in the backward (the reference's
    # checkpointed scan over groups)
    remat = "full" if g > 1 else "none"
    y = torch.stack([checkpointed(_moe_group, xg[i], p, cfg, router_bits, w,
                                  remat=remat) for i in range(g)])
    return y.reshape(b, s, d)


def _moe_group(
    xt: torch.Tensor,             # (T, D) — one token group
    p: dict,
    cfg: ModelConfig,
    router_bits: dict | None,
    w: dict | None,               # expert weights in x's dtype, or None
) -> torch.Tensor:
    t, d = xt.shape
    e = cfg.n_experts
    dt = xt.dtype
    if w is None:
        w = {n: p[n].to(dt) for n in _EXPERT_WEIGHTS}
    top_w, top_i = route(xt, p, cfg, router_bits)
    k = top_i.shape[1]

    c = capacity(cfg, t)
    flat_e = top_i.reshape(-1)                              # (T*k,)
    pos = _positions_in_expert(flat_e, e)
    keep = pos < c
    slot = torch.where(keep, flat_e * c + pos, e * c)       # overflow -> slot E*C

    x_rep = torch.repeat_interleave(xt, k, dim=0)           # (T*k, D)
    src = torch.where(keep[:, None], x_rep, 0)
    # every dropped dispatch writes zeros to the one overflow row, so the
    # order of those duplicate writes does not matter
    buf = torch.zeros((e * c + 1, d), dtype=dt, device=xt.device)
    buf[slot] = src
    h = buf[: e * c].reshape(e, c, d)

    gg = torch.bmm(h, w["w_gate"])
    u = torch.bmm(h, w["w_up"])
    out = torch.bmm(act_fn(gg, cfg.mlp_act) * u, w["w_down"])

    out_flat = torch.cat(
        [out.reshape(e * c, d), torch.zeros((1, d), dtype=dt,
                                            device=xt.device)], dim=0)
    y_disp = out_flat[slot] * keep[:, None].to(dt)          # (T*k, D)
    return (y_disp.reshape(t, k, d)
            * top_w.reshape(t, k, 1).to(dt)).sum(dim=1)
