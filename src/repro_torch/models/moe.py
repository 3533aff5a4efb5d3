"""Mixture-of-Experts FFN: top-k routing with capacity-bounded scatter/gather
dispatch (no giant one-hot dispatch einsums).

Dispatch: tokens are ranked within their chosen expert by a stable sort;
tokens beyond an expert's capacity ``C = ceil(cf * T * k / E)`` (rounded up
to a multiple of 8) are dropped (standard GShard/Switch semantics).  The
(E, C, D) expert buffer is the only materialized dispatch structure:
bytes = E*C*D ~= cf * k * tokens * d_model, independent of E.

Token groups (``cfg.moe_groups``, GShard style) each have their own
capacity, and each dispatch is ranked within its group and expert.  Serving
routes the layer call's tokens once and runs its groups side by side on each
expert's capacity axis: one expert pass a layer call, which reads each
expert weight once, cast to the compute dtype once.  Training runs one group
at a time, each recomputed in the backward (the reference's checkpointed
scan over groups), so that the dispatch transients scale 1/g.  Gradients
reach the router only through the top-k gates that were gathered; a
dispatch dropped over capacity gets none.

``router="tcam_dt"``: routing decisions come from a decision tree compiled to
a ternary LUT by the paper's DT-HW compiler and evaluated as a ternary match
— see ``tcam_router.py``.
"""
from __future__ import annotations

import torch

from .. import obs
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
          router_bits: dict | None = None, *, shards=None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, D) tokens -> (top_w (T, k) f32, top_i (T, k) int64) expert
    choices; k is 1 for the TCAM router.  With ``shards`` and the router's
    expert columns split over "model", the logits of this rank's columns
    are all-gathered before the softmax."""
    if cfg.router == "tcam_dt":
        from .tcam_router import route_tcam
        assert router_bits is not None, "tcam_dt router needs compiled bits"
        top_i = route_tcam(xt, router_bits)[:, None]         # (T, 1) top-1
        return torch.ones(top_i.shape, dtype=torch.float32,
                          device=xt.device), top_i
    logits = xt.float() @ p["w_router"].float()
    if logits.shape[1] < cfg.n_experts:
        logits = shards.gather(logits, "model", 1)
    gates = torch.softmax(logits, dim=-1)
    # Sorted descending, as jax.lax.top_k.  On equal gates lax.top_k takes
    # the lower index first; torch.topk does not promise an order among
    # ties.  With f32 gates from real-valued logits a tie is unlikely.
    top_w, top_i = torch.topk(gates, cfg.experts_per_token, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(dim=-1, keepdim=True), 1e-9)
    return top_w, top_i


def _route(xt, p, cfg, router_bits, shards):
    # unsharded, ``route`` is called as it always was (tools patch it)
    with obs.span("moe.route"):
        if shards is None:
            return route(xt, p, cfg, router_bits)
        return route(xt, p, cfg, router_bits, shards=shards)


def _cast(p: dict, dt: torch.dtype) -> dict:
    """The expert weights in the compute dtype."""
    with obs.span("moe.cast"):
        return {n: p[n].to(dt) for n in _EXPERT_WEIGHTS}


def moe_ffn(
    x: torch.Tensor,              # (B, S, D)
    p: dict,                      # w_router (D,E), w_gate/w_up (E,D,F), w_down (E,F,D)
    cfg: ModelConfig,
    *,
    router_bits: dict | None = None,   # tcam_dt router tensors (see tcam_router)
    shards=None,                  # sharded serving: this rank's part
) -> torch.Tensor:
    """The MoE layer.  With ``shards`` (``sharding.collectives.Shards``),
    ``x`` is this rank's rows of the batch (serving's, or a microbatch of
    the train step) and ``p`` its shards.  The token groups and their
    capacity are the whole batch's, as the reference's (GSPMD keeps global
    semantics): where the groups split evenly over the batch's shards a
    rank runs its own groups; otherwise its tokens share groups with other
    ranks, and the expert choices of every token are gathered over the
    batch axes (integers: no gradient) so that each dispatch is ranked in
    the global order.  Experts split over "model" run only this rank's
    experts, on ``x`` entered into its part (``Shards.enter``), as the
    router's logits of its experts' columns are; the combined outputs are
    then partial sums, added over "model"."""
    with obs.span("lm.moe"):
        b, s, d = x.shape
        t = b * s
        n_shards = 1 if shards is None else shards.batch_shards
        tg = t * n_shards                                   # global tokens
        g = cfg.moe_groups if tg % cfg.moe_groups == 0 else 1  # decode: t=B
        # Serving casts the expert weights once per layer call and runs the
        # groups side by side in one expert pass.  With a gradient each group
        # casts its own inside its checkpoint, so the f32 leaves collect the
        # groups' gradients in f32, as the reference's per-group cast does.
        serving = not torch.is_grad_enabled()
        w = _cast(p, x.dtype) if serving else None
        split = p["w_gate"].shape[0] < cfg.n_experts  # this rank's experts
        if split:
            x = shards.enter(x)      # into the router's and experts' columns
        if g % n_shards:
            y = _moe_groups(x.reshape(t, d), p, cfg, router_bits, w, shards,
                            tg // g, spanning=True)
        elif serving or g == n_shards:
            y = _moe_groups(x.reshape(t, d), p, cfg, router_bits, w, shards,
                            tg // g)
        else:
            g //= n_shards                                  # this rank's
            xg = x.reshape(g, t // g, d)
            # one group at a time, each recomputed in the backward
            y = torch.stack([checkpointed(_moe_groups, xg[i], p, cfg,
                                          router_bits, w, shards, t // g)
                             for i in range(g)])
        if split:
            y = shards.sum(y, "model")
        return y.reshape(b, s, d)


def _local_experts(p: dict, cfg: ModelConfig, shards) -> tuple[int, int]:
    """(first, count) of the experts whose weights ``p`` holds."""
    n = p["w_gate"].shape[0]
    return (0, n) if n == cfg.n_experts else (shards.rank("model") * n, n)


def _gates_in(top_w, ne: int, cfg: ModelConfig, shards):
    """The gates as the input of this rank's experts' combine: where the
    experts split over "model", each rank's gradient of the gates is its
    experts' part, summed over "model" (``Shards.enter``), so the router's
    softmax and the gather of its logits see the whole gradient."""
    return shards.enter(top_w) if ne < cfg.n_experts else top_w


def _moe_groups(xt, p, cfg, router_bits, w, shards, per: int,
                spanning: bool = False) -> torch.Tensor:
    """This rank's tokens ``xt`` (T, D), in token groups of ``per`` tokens
    side by side on each expert's capacity axis: routed once, each dispatch
    ranked within its group and expert, one expert pass.  ``spanning``: the
    groups do not split evenly over the batch shards, so the expert choices
    of every token are gathered over the batch axes (in the global token
    order) and ranked there, and this rank runs its own dispatches.  In the
    train step the gradient reaches ``xt`` and the router through this
    rank's dispatches and gates (the ranking has none); the gather runs
    again where the layer is recomputed."""
    t, d = xt.shape
    e = cfg.n_experts
    if w is None:
        w = _cast(p, xt.dtype)
    top_w, top_i = _route(xt, p, cfg, router_bits, shards)
    k = top_i.shape[1]
    every, first = top_i, 0
    if spanning:
        every = shards.gather(top_i, shards.batch_axes, 0)  # (T_global, k)
        first = shards.batch_index * t
    n = every.shape[0]
    g0, g1 = first // per, (first + t - 1) // per           # this rank's
    with obs.span("moe.dispatch"):
        if n == per:                                        # one group
            pos, group = _positions_in_expert(every.reshape(-1), e), None
        else:
            group = torch.arange(n, device=xt.device) // per
            pos = _positions_in_expert(
                (group[:, None] * e + every).reshape(-1), n // per * e)
            group = (group[first:first + t] - g0).repeat_interleave(k)
        pos = pos[first * k:(first + t) * k]
    e0, ne = _local_experts(p, cfg, shards)
    top_w = _gates_in(top_w, ne, cfg, shards)
    return _experts(xt, top_w, top_i.reshape(-1), pos, capacity(cfg, per),
                    g1 - g0 + 1, e0, ne, w, cfg, group)


def _experts(xt, top_w, flat_e, pos, c: int, groups: int, e0: int, ne: int,
             w: dict, cfg: ModelConfig, group=None) -> torch.Tensor:
    """Dispatch, expert FFNs and combine of tokens ``xt`` (T, D) with
    choices ``flat_e`` (T*k,), ranked ``pos`` within their expert (and
    ``group``, of ``groups`` side by side), capacity ``c``: experts
    [e0, e0 + ne) only (the others' dispatches are left out)."""
    t, d = xt.shape
    k = flat_e.shape[0] // t
    dt = xt.dtype
    rows = groups * c                                       # per expert
    with obs.span("moe.dispatch"):
        keep = pos < c
        if ne < cfg.n_experts:
            keep &= (flat_e >= e0) & (flat_e < e0 + ne)
            flat_e = flat_e - e0
        if obs.counting():
            obs.add("moe.passes", 1)
            obs.add("moe.pass_groups", groups)
            obs.add("moe.dispatched", t * k)
            obs.add("moe.kept", keep.sum())
            obs.add("moe.slots", ne * rows)
        at = pos if group is None else group * c + pos
        slot = torch.where(keep, flat_e * rows + at, ne * rows)  # overflow

        x_rep = torch.repeat_interleave(xt, k, dim=0)       # (T*k, D)
        src = torch.where(keep[:, None], x_rep, 0)
        # every dropped dispatch writes zeros to the one overflow row, so
        # the order of those duplicate writes does not matter
        buf = torch.zeros((ne * rows + 1, d), dtype=dt, device=xt.device)
        buf[slot] = src
        h = buf[: ne * rows].reshape(ne, rows, d)

    with obs.span("moe.experts"):
        gg = torch.bmm(h, w["w_gate"])
        u = torch.bmm(h, w["w_up"])
        out = torch.bmm(act_fn(gg, cfg.mlp_act) * u, w["w_down"])

    with obs.span("moe.combine"):
        out_flat = torch.cat(
            [out.reshape(ne * rows, d), torch.zeros((1, d), dtype=dt,
                                                    device=xt.device)], dim=0)
        y_disp = out_flat[slot] * keep[:, None].to(dt)      # (T*k, D)
        return (y_disp.reshape(t, k, d)
                * top_w.reshape(t, k, 1).to(dt)).sum(dim=1)
