"""The model stack: forward / training loss / prefill / decode for every
configuration: the attention families (block kinds ``attn``/``swa`` x
``mlp``/``moe``, with the multimodal prefix), the recurrent mixers
(``mamba``, ``rwkv`` with its channel mix ``cmix``) and the
encoder-decoder with cross-attention.

Layers run as a Python loop over the stacked per-kind params in the order of
``cfg.pattern`` repeated ``cfg.n_repeat`` times; layer ``r`` of kind ``k``
reads slice ``r * occ_k + i`` of its kind's stacked leaves.

Modes:
  forward     — full-sequence logits (evaluation; no cache I/O),
  loss_fn     — full sequence, chunked next-token cross-entropy, with the
                graph recorded for the backward (training),
  prefill     — full sequence, fills the caches, returns the last logits,
  decode_step — one token against the caches.

KV caches are ring buffers (slot = pos % cache_len) with a per-slot absolute
position table, which unifies full-window and sliding-window (SWA) decode.
The recurrent kinds cache their state instead (mamba: the conv's last K-1
inputs and the SSM state; rwkv: the token shifts and the WKV state), and an
encoder-decoder caches each decoder layer's projected encoder keys and
values.  ``prefill`` and ``decode_step`` write each layer's slice of the
stacked caches in place (``copy_`` into the views) and return the same dict.

The model code carries no sharding annotations: the JAX package's
``shard`` calls only constrain layouts for its compiler.  Across devices
the data-parallel train step (``train.build_train_step(..., rules=)``
under ``dp_only`` rules) gathers the whole param tree before calling
``loss_fn`` and reduce-scatters the gradients itself.  The sharded train
step (``loss_fn`` with ``shards=``) and sharded serving (``prefill``/
``decode_step`` with ``shards=``), a ``sharding.collectives.Shards``, run
one rank's part of the step on its rows of the batch, its param shards
(``models.params.shard_params``) and its cache shards (``init_cache(...,
rules=)``), with the collectives explicit and each with its backward:
each layer's weights gathered over the FSDP axes at use (their gradients
reduce-scattered back), the vocab-parallel embedding, head and
cross-entropy, the query heads (and their kv heads) of this rank with the
output projection's partial sums all-reduced over "model"
(``Shards.dot``: in f32, rounded once), decode over a cache whose
``head_dim`` is split by all-reducing the partial query-key scores, or
over a cache split by ring slots (the batch-1 long-context layout) by
combining the softmax over the ranks, the MLP's ``mlp`` columns and the
MoE's experts (``moe.moe_ffn``), mamba's inner dim, rwkv6's heads and
channel-mix hidden dim and whisper's cross-attention heads split over
"model".  Each stretch of rank-local work starts at ``Shards.enter`` on
the replicated tensors it reads, weights that rest whole on every rank of
"model" (heads' and inner dims' projections, the head norms) included,
and ends at a sum over "model", so every gradient comes back whole.
Without ``shards`` the path is the unsharded one, and on a mesh of one the
sharded path runs the same operations on the same tensors.
``jax.checkpoint`` maps to ``torch.utils.checkpoint`` (``layers.checkpointed``)
at the same places: a repeat of ``cfg.pattern`` under ``remat``, each loss
chunk, each attention query chunk, each MoE token group, each mamba and
rwkv chunk.  The serving entry points run without a gradient; ``loss_fn``
records one.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import obs
from ..device import DeviceLike, resolve_device
from ..sharding.collectives import Shards
from .attention import decode_attention, flash_attention
from .config import ModelConfig
from .layers import (COMPUTE_DTYPE, checkpointed, mlp, nonparam_norm,
                     rms_norm, rope, rope_table)
from .mamba import init_mamba_state, mamba_mixer
from .moe import moe_ffn
from .rwkv import init_rwkv_state, rwkv_channel_mix, rwkv_mixer

__all__ = ["forward", "loss_fn", "prefill", "decode_step", "init_cache",
           "encode_audio", "cache_logical_axes"]


@dataclasses.dataclass
class Ctx:
    mode: str                         # "full" | "prefill" | "decode"
    sin: torch.Tensor | None = None   # rope tables for the current positions
    cos: torch.Tensor | None = None
    pos: int = 0                      # decode: position of the new token
    prefix_len: int = 0
    enc_out: torch.Tensor | None = None   # encdec: encoder activations
    causal: bool = True
    shards: Shards | None = None      # sharded serving: this rank's part
    ring: dict = dataclasses.field(default_factory=dict)
    # kind -> its KV cache's slots (the whole ring's, sharded too)


def _w(shards: Shards | None, a, idx: int | None = None):
    """Param leaf ``a`` (slice ``idx`` of a stacked one) as it is used:
    itself unsharded, else this rank's shard gathered over the FSDP
    axes."""
    if shards is None:
        return a if idx is None else a[idx]
    return shards.at_use(a, idx)


# the weights of the heads, whole on every rank of "model" (the rules map
# no "qkv" dim there): a rank that runs some heads enters them
_ATTN_WEIGHTS = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_CROSS_WEIGHTS = ("xwq", "xwk", "xwv", "xwo")


def _span(w: torch.Tensor, dim: int, lo: int, n: int, size: int):
    """Entries [lo, lo + n) of ``w``'s ``dim``, in blocks of ``size``; ``w``
    itself where that is all of it."""
    if lo == 0 and n * size == w.shape[dim]:
        return w
    return w.narrow(dim, lo * size, n * size)


def _kv_serving(t: torch.Tensor, q0: int, nq: int, k0: int, g: int):
    """The kv heads of ``t`` (B, S, n, hd), which holds the model's kv
    heads from ``k0`` on, that query heads [q0, q0 + nq) read under
    grouped-query attention (``g`` query heads a kv head), laid out so that
    attention pairs local query head ``j`` with kv head ``j // (nq / n)``
    of the result: a slice where the query heads cover whole groups or lie
    in one, else one kv head per query head."""
    lo, hi = q0 // g, (q0 + nq - 1) // g + 1
    if nq % g == 0 or g % nq == 0:
        return _span(t, 2, lo - k0, hi - lo, 1)
    idx = (torch.arange(q0, q0 + nq, device=t.device) // g) - k0
    return t.index_select(2, idx)


def _ring_runs(lo: int, hi: int, clen: int, c0: int, n: int) -> list:
    """The positions of [lo, hi) (``hi - lo <= clen``) whose ring slots
    ``pos % clen`` lie in [c0, c0 + n), as runs ``(first, stop, slot)``:
    positions [first, stop) go to slots [slot, slot + stop - first) counted
    from ``c0``."""
    out = []
    for lap in range(lo // clen, (hi - 1) // clen + 1):
        a, b = max(lo, lap * clen + c0), min(hi, lap * clen + c0 + n)
        if a < b:
            out.append((a, b, a - lap * clen - c0))
    return out


def _norm(x, scale, cfg: ModelConfig):
    if cfg.norm_type == "nonparam":
        return nonparam_norm(x, cfg.norm_eps)
    return rms_norm(x, scale, cfg.norm_eps)


def _qk_headnorm(q, p, cfg, name):
    if not cfg.qk_norm:
        return q
    return rms_norm(q, p[name], cfg.norm_eps)


def _cache_len(cfg: ModelConfig, mixer: str, max_seq: int) -> int:
    if mixer == "swa" and cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_seq)
    return max_seq


# ---------------------------------------------------------------------------
# mixers
# ---------------------------------------------------------------------------
def _attention_mixer(kind, h, p, cfg: ModelConfig, ctx: Ctx, cache):
    """Self-attention.  Sharded, a rank computes query heads [q0, q0 + nq)
    and kv heads [k0, k0 + nk) (all of them where "model" does not divide
    the count), writes its part of the cache (its kv heads, or its
    ``head_dim`` columns of every kv head), and its output projection is a
    partial sum over "model".  Decode over a cache whose ``head_dim`` is
    split runs every head on the rank's columns, its query-key scores
    summed over "model".

    A cache split by sequence (``cache_seq``, the batch-1 long-context
    layout) holds ring slots [c0, c0 + n) of every kv head on the rank:
    it computes every kv head's k and v and writes those of its slots.
    Decode runs every head over the rank's slots, the softmax combined over
    the ranks of ``cache_seq`` (``decode_attention``'s ``seq_max`` and
    ``seq_sum``), so every rank holds every head's output and runs the
    whole output projection, with no sum over "model"."""
    mixer = kind.split("+")[0]
    window = cfg.sliding_window if mixer == "swa" else 0
    b, s, d = h.shape
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = h.dtype
    sh = ctx.shards
    q0, nq = (0, nh) if sh is None else sh.local("act_heads", nh)
    k0, nk = (0, kv) if sh is None else sh.local("act_kv_heads", kv)
    # the ring slots this rank holds: all, or its stretch of the sequence
    clen = 0 if cache is None else ctx.ring[kind]
    c0, n = (0, clen) if sh is None else sh.local("cache_seq", clen)
    split_seq = n < clen
    if split_seq:
        assert cache["k"].shape[1] == n, (cache["k"].shape, n)
        k0, nk = 0, kv
    # the cache's head_dim columns this rank holds: all, or its share
    hdc = hd if cache is None else cache["k"].shape[-1]
    h0 = 0 if hdc == hd else sh.rank("model") * hdc
    split_hd = ctx.mode == "decode" and hdc < hd
    if split_hd or (split_seq and ctx.mode == "decode"):
        q0, nq = 0, nh          # every head, on this rank's columns or slots
    # this rank's heads (or head_dim columns) give a partial sum over "model"
    partial = split_hd or nq < nh
    x = _norm(h, p["norm1"], cfg)
    if partial:
        x, p = sh.enter(x), sh.enter_all(p, _ATTN_WEIGHTS)
    q = (x @ _span(p["wq"], 1, q0, nq, hd).to(dt)).reshape(b, s, nq, hd)
    k = (x @ _span(p["wk"], 1, k0, nk, hd).to(dt)).reshape(b, s, nk, hd)
    v = (x @ _span(p["wv"], 1, k0, nk, hd).to(dt)).reshape(b, s, nk, hd)
    q = _qk_headnorm(q, p, cfg, "q_norm")
    k = _qk_headnorm(k, p, cfg, "k_norm")
    if cfg.rope_theta > 0:
        q = rope(q, ctx.sin, ctx.cos)
        k = rope(k, ctx.sin, ctx.cos)
    g = nh // kv

    if ctx.mode == "decode":
        for _, _, j in _ring_runs(ctx.pos, ctx.pos + 1, clen, c0, n):
            cache["k"][:, j:j + 1] = _span(k, 3, h0, hdc, 1).to(
                cache["k"].dtype)
            cache["v"][:, j:j + 1] = _span(v, 3, h0, hdc, 1).to(
                cache["v"].dtype)
        cache["slot_pos"][ctx.pos % clen] = ctx.pos
        if split_hd:
            o = decode_attention(
                _span(q, 3, h0, hdc, 1), cache["k"], cache["v"],
                cache["slot_pos"], ctx.pos, window=window, scale=hd ** -0.5,
                scores_sum=lambda t: sh.sum(t, "model"))
        else:
            seq = {}
            if split_seq:
                axes = sh.rules.table["cache_seq"]
                seq = dict(seq_max=lambda t: sh.max(t, axes),
                           seq_sum=lambda t: sh.sum(t, axes))
            o = decode_attention(
                q, _kv_serving(cache["k"], q0, nq, k0, g),
                _kv_serving(cache["v"], q0, nq, k0, g),
                cache["slot_pos"][c0:c0 + n], ctx.pos, window=window, **seq)
    else:
        o = flash_attention(q, _kv_serving(k, q0, nq, k0, g),
                            _kv_serving(v, q0, nq, k0, g), causal=ctx.causal,
                            window=window, prefix_len=ctx.prefix_len)
        if ctx.mode == "prefill":
            lo = s - min(s, clen)           # the positions the ring keeps
            for a, e, j in _ring_runs(lo, s, clen, c0, n):
                cache["k"][:, j:j + e - a] = _span(k[:, a:e], 3, h0, hdc,
                                                   1).to(cache["k"].dtype)
                cache["v"][:, j:j + e - a] = _span(v[:, a:e], 3, h0, hdc,
                                                   1).to(cache["v"].dtype)
            for a, e, j in _ring_runs(lo, s, clen, 0, clen):
                cache["slot_pos"][j:j + e - a] = torch.arange(
                    a, e, dtype=cache["slot_pos"].dtype, device=h.device)

    wo = p["wo"]
    if split_hd:
        wo = _span(wo.reshape(nh, hd, d), 1, h0, hdc, 1).reshape(-1, d)
    else:
        wo = _span(wo, 0, q0, nq, hd)
    o = o.reshape(b, s, -1)
    if partial:                      # a partial sum of this rank's heads
        return h + sh.dot(o, wo.to(dt))
    return h + o @ wo.to(dt)


def _cross_mixer(h, p, cfg: ModelConfig, ctx: Ctx, cache):
    """Whisper decoder cross-attention over encoder outputs.  Sharded, a
    rank runs query heads [q0, q0 + nq) (``act_heads``, the heads of its
    ``xk``/``xv`` caches) and its output projection is a partial sum over
    "model"."""
    b, s, d = h.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    dt = h.dtype
    sh = ctx.shards
    q0, nq = (0, nh) if sh is None else sh.local("act_heads", nh)
    x = _norm(h, p["norm_x"], cfg)
    enc = ctx.enc_out
    if nq < nh:
        x, p = sh.enter(x), sh.enter_all(p, _CROSS_WEIGHTS)
        enc = None if enc is None else sh.enter(enc)
    q = (x @ _span(p["xwq"], 1, q0, nq, hd).to(dt)).reshape(b, s, nq, hd)
    if ctx.mode == "decode":
        xk, xv = cache["xk"], cache["xv"]
        sp = torch.arange(xk.shape[1], dtype=torch.int32, device=h.device)
        o = decode_attention(q, xk, xv, sp, 2**30)
    else:
        xk = (enc @ _span(p["xwk"], 1, q0, nq, hd).to(dt)).reshape(
            b, enc.shape[1], nq, hd)
        xv = (enc @ _span(p["xwv"], 1, q0, nq, hd).to(dt)).reshape(
            b, enc.shape[1], nq, hd)
        o = flash_attention(q, xk, xv, causal=False)
        if ctx.mode == "prefill":
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
    o = o.reshape(b, s, nq * hd)
    wo = _span(p["xwo"], 0, q0, nq, hd).to(dt)
    if nq < nh:                      # a partial sum of this rank's heads
        return h + sh.dot(o, wo)
    return h + o @ wo


def _apply_block(kind, h, p, cfg: ModelConfig, ctx: Ctx, cache):
    """One layer; a recurrent mixer's new state is copied into its cache
    views (rebinding a key of ``cache`` would lose it)."""
    mixer, ffn = kind.split("+")
    if mixer in ("attn", "swa"):
        with obs.span("lm.attention"):
            h = _attention_mixer(kind, h, p, cfg, ctx, cache)
    elif mixer == "mamba":
        x = _norm(h, p["norm1"], cfg)
        if ctx.mode == "full":
            h = h + mamba_mixer(x, p, cfg, shards=ctx.shards)
        else:
            out, (conv, hst) = mamba_mixer(
                x, p, cfg, state=(cache["conv"], cache["h"]),
                return_state=True, shards=ctx.shards)
            h = h + out
            cache["conv"].copy_(conv)
            cache["h"].copy_(hst)
    elif mixer == "rwkv":
        x = _norm(h, p["norm1"], cfg)
        if ctx.mode == "full":
            h = h + rwkv_mixer(x, p, cfg, shards=ctx.shards)
        else:
            out, (xa, sst) = rwkv_mixer(
                x, p, cfg, state=(cache["xa"].to(x.dtype), cache["S"]),
                return_state=True, shards=ctx.shards)
            h = h + out
            cache["xa"].copy_(xa)
            cache["S"].copy_(sst)
    else:
        raise ValueError(mixer)

    if cfg.is_encdec:
        h = _cross_mixer(h, p, cfg, ctx, cache)

    x = _norm(h, p["norm2"], cfg)
    if ffn == "mlp":
        # sharded over "mlp", w_down's products are partial sums
        split = p["w_down"].shape[0] < cfg.d_ff
        if split:
            x = ctx.shards.enter(x)
        h = h + mlp(x, p, cfg.mlp_act,
                    dot=ctx.shards.dot if split else None)
    elif ffn == "moe":
        # as the reference (``repro/models/lm.py:194``): no router bits are
        # passed, so a model configured with router="tcam_dt" fails moe_ffn's
        # assertion; the TCAM router is reached through moe_ffn directly
        h = h + moe_ffn(x, p, cfg, shards=ctx.shards)
    elif ffn == "cmix":
        if ctx.mode == "full":
            h = h + rwkv_channel_mix(x, p, cfg, shards=ctx.shards)
        else:
            out, xc = rwkv_channel_mix(x, p, cfg,
                                       state=cache["xc"].to(x.dtype),
                                       return_state=True, shards=ctx.shards)
            h = h + out
            cache["xc"].copy_(xc)
    else:
        raise ValueError(ffn)
    return h


def _run_blocks(cfg: ModelConfig, blocks: dict, caches, h, ctx: Ctx,
                remat: str = "none"):
    """Every layer in order; each layer's cache slice is updated in place.
    ``remat`` (``"none"``, ``"dots"``, ``"full"``) recomputes each repeat of
    ``cfg.pattern`` in the backward, as the reference's checkpointed scan
    body."""
    occ_per = {kind: len(cfg.kind_positions(kind)) for kind in blocks}

    def unit(h, r):
        counters = {kind: 0 for kind in blocks}
        for kind in cfg.pattern:
            idx = r * occ_per[kind] + counters[kind]
            counters[kind] += 1
            # sharded: this layer's weights gathered at use, freed after it
            p_i = {name: _w(ctx.shards, a, idx)
                   for name, a in blocks[kind].items()}
            c_i = (None if caches is None else
                   {name: a[idx] for name, a in caches[kind].items()})
            h = _apply_block(kind, h, p_i, cfg, ctx, c_i)
        return h

    for r in range(cfg.n_repeat):
        h = checkpointed(unit, h, r, remat=remat)
    return h


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def _embed(params, cfg: ModelConfig, tokens, frontend=None,
           shards: Shards | None = None):
    table = _w(shards, params["embed"])
    tokens = torch.as_tensor(tokens, device=table.device).long()
    if table.shape[0] < cfg.vocab_size:     # rows split over "model"
        h = shards.lookup(table, tokens).to(COMPUTE_DTYPE)
    else:
        h = table[tokens].to(COMPUTE_DTYPE)
    if cfg.emb_scale:
        # sqrt(d_model) is rounded to bf16 before the multiply, as there
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=COMPUTE_DTYPE,
                             device=h.device)
    if frontend is not None:
        frontend = torch.as_tensor(frontend, device=h.device)
        h = torch.cat([frontend.to(COMPUTE_DTYPE), h], dim=1)
    return h


def _logits(params, cfg: ModelConfig, h, shards: Shards | None = None):
    """Logits of ``h``; sharded, this rank's vocab columns as the
    ``DTensor`` of the global logits."""
    out = h @ _head(params, cfg, shards).to(h.dtype)
    return out if shards is None else shards.logits(out, cfg.vocab_size)


def _rope_tables(cfg: ModelConfig, positions):
    if cfg.rope_theta <= 0:
        return None, None
    return rope_table(positions, cfg.head_dim, cfg.rope_theta)


def _encode(params, cfg: ModelConfig, frames, remat: str,
            shards: Shards | None = None):
    enc = params["encoder"]
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass frames=")
    pos_emb = _w(shards, enc["pos_emb"])
    frames = torch.as_tensor(frames, device=pos_emb.device)
    h = frames.to(COMPUTE_DTYPE) + pos_emb[None].to(COMPUTE_DTYPE)
    cfg_enc = dataclasses.replace(cfg, encoder_layers=0,
                                  n_layers=cfg.encoder_layers,
                                  pattern=("attn+mlp",))
    sin, cos = _rope_tables(cfg, torch.arange(h.shape[1], device=h.device))
    ctx = Ctx(mode="full", sin=sin, cos=cos, causal=False, shards=shards)
    h = _run_blocks(cfg_enc, enc["blocks"], None, h, ctx, remat=remat)
    return _norm(h, _w(shards, enc["final_norm"]), cfg)


@torch.no_grad()
def encode_audio(params, cfg: ModelConfig, frames):
    """Whisper encoder: frames are stub frontend embeddings (B, S_enc, D);
    non-causal ``attn+mlp`` blocks without cross-attention, then the
    encoder's final norm."""
    return _encode(params, cfg, frames, "none")


def _start(params, cfg: ModelConfig, tokens, frontend, frames,
           remat: str = "none", shards: Shards | None = None):
    """The encoder's output (encoder-decoder only) and the embedded tokens
    with the decoder's positions added."""
    enc_out = (_encode(params, cfg, frames, remat, shards) if cfg.is_encdec
               else None)
    h = _embed(params, cfg, tokens, frontend, shards)
    if cfg.is_encdec:
        h = h + _w(shards, params["dec_pos_emb"])[None, :h.shape[1]].to(
            h.dtype)
    return enc_out, h


def _hidden(params, cfg: ModelConfig, tokens, frontend, frames,
            remat: str = "none", shards: Shards | None = None):
    """The final-normed hidden states (B, S, D) of the full sequence; with
    ``shards``, of this rank's rows."""
    enc_out, h = _start(params, cfg, tokens, frontend, frames, remat, shards)
    s = h.shape[1]
    sin, cos = _rope_tables(cfg, torch.arange(s, device=h.device))
    ctx = Ctx(mode="full", sin=sin, cos=cos, prefix_len=cfg.frontend_tokens,
              enc_out=enc_out, shards=shards)
    h = _run_blocks(cfg, params["blocks"], None, h, ctx, remat=remat)
    return _norm(h, _w(shards, params["final_norm"]), cfg)


def _head(params, cfg: ModelConfig, shards: Shards | None = None):
    if cfg.tie_embeddings:
        return _w(shards, params["embed"]).T
    return _w(shards, params["lm_head"])


@torch.no_grad()
def forward(params, cfg: ModelConfig, tokens, *, frontend=None, frames=None):
    """Full-sequence activations -> logits (B, S, V) in bf16; an
    encoder-decoder takes its encoder's input as ``frames``."""
    return _logits(params, cfg, _hidden(params, cfg, tokens, frontend,
                                        frames))


def _chunk_loss(hc, lc, w, shards: Shards | None = None):
    """Summed next-token cross-entropy of one chunk, and its label count.
    With ``shards`` (``w`` this rank's vocab columns), the vocab-parallel
    form (Megatron's): the max over "model" (no gradient), the sum of the
    exponentials over "model", and the gold logit from the rank whose
    columns hold the label, summed over "model"."""
    logits = (hc @ w.to(hc.dtype)).float()
    valid = lc >= 0
    n = logits.shape[-1]
    if shards is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc.clamp_min(0)[..., None])[..., 0]
    else:
        m = shards.max(logits.amax(dim=-1), "model")
        lse = torch.log(shards.sum(torch.exp(logits - m[..., None]).sum(-1),
                                   "model")) + m
        local = lc - shards.rank("model") * n
        inside = (local >= 0) & (local < n)
        gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = shards.sum(torch.where(inside, gold, 0.0), "model")
    return ((lse - gold) * valid).sum(), valid.sum(dtype=torch.int32)


def loss_fn(params, cfg: ModelConfig, batch, *, remat: str = "dots",
            loss_chunk: int = 1024, shards: Shards | None = None):
    """Next-token CE with seq-chunked logits (peak memory ~ B x chunk x V);
    labels of -1 (and a multimodal prefix's positions) carry no loss.
    Records the graph for a backward pass; each chunk's logits are
    recomputed there.  ``batch`` holds ``tokens`` and ``labels`` (B, S_text)
    and, per configuration, ``patches`` or ``frames``.  Returns
    (loss, {"loss", "tokens"}).  With ``shards``, one rank's part of the
    sharded train step: ``batch`` is this rank's rows of the microbatch
    ``shards.batch``, ``params`` its ``DTensor`` shards, the collectives
    explicit (each with its backward), and the head's vocab columns split
    over "model" (the vocab-parallel cross-entropy).  The loss is the whole
    microbatch's, the same on every rank: its summed token loss and its
    label count are each summed over the batch axes (``Shards.sum``, whose
    backward passes the gradient unchanged), so each rank's gradient is its
    rows' part of the whole microbatch's, as the reference divides by the
    microbatch's whole label count."""
    h = _hidden(params, cfg, batch["tokens"], batch.get("patches"),
                batch.get("frames"), remat, shards)
    labels = torch.as_tensor(batch["labels"], device=h.device).long()
    if cfg.frontend_tokens:
        # frontend positions carry no next-token loss
        pad = labels.new_full((labels.shape[0], cfg.frontend_tokens), -1)
        labels = torch.cat([pad, labels], dim=1)
    w = _head(params, cfg, shards)
    rows = shards                      # the microbatch's rows over the mesh
    if shards is not None and w.shape[1] < cfg.vocab_size:
        h = shards.enter(h)            # into this rank's vocab columns
    else:
        shards = None
    s = h.shape[1]
    chunk = min(loss_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk "
                         f"{chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    for c0 in range(0, s, chunk):
        loss, n = checkpointed(_chunk_loss, h[:, c0:c0 + chunk],
                               labels[:, c0:c0 + chunk], w, shards)
        tot, cnt = tot + loss, cnt + n
    if rows is not None:
        tot, cnt = rows.sum(tot, rows.batch_axes), rows.sum(cnt,
                                                            rows.batch_axes)
    loss = tot / torch.clamp_min(cnt, 1)
    return loss, {"loss": loss, "tokens": cnt}


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """Logical axes mirroring ``init_cache``'s structure."""
    table = {
        "k": ("layers", "act_batch", "cache_seq", "act_kv_heads", "act_hd"),
        "v": ("layers", "act_batch", "cache_seq", "act_kv_heads", "act_hd"),
        "slot_pos": ("layers", None),
        "conv": ("layers", "act_batch", None, "act_dinner"),
        "h": ("layers", "act_batch", "act_dinner", None),
        "xa": ("layers", "act_batch", None),
        "S": ("layers", "act_batch", None, None, None),
        "xc": ("layers", "act_batch", None),
        "xk": ("layers", "act_batch", None, "act_heads", None),
        "xv": ("layers", "act_batch", None, "act_heads", None),
    }
    out = {}
    for kind in cfg.kinds:
        mixer, ffn = kind.split("+")
        names = []
        if mixer in ("attn", "swa"):
            names += ["k", "v", "slot_pos"]
        elif mixer == "mamba":
            names += ["conv", "h"]
        elif mixer == "rwkv":
            names += ["xa", "S", "xc"]
        if ffn == "cmix" and "xc" not in names:
            names.append("xc")
        if cfg.is_encdec:
            names += ["xk", "xv"]
        out[kind] = {n: table[n] for n in names}
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               dtype: torch.dtype = COMPUTE_DTYPE,
               device: DeviceLike = None, rules=None) -> dict:
    """Stacked per-kind decode caches on ``device`` (default: the card).
    With ``rules`` over a ``DeviceMesh``, each leaf is a ``DTensor`` laid
    out by its spec (``cache_logical_axes``) and this rank allocates only
    its shard."""
    dev = resolve_device(device)
    if rules is not None:
        return _sharded_cache(cfg, batch, max_seq, dtype, dev, rules)
    caches = {}
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def stack(t, occ):
        return t[None].repeat(occ, *(1,) * t.dim())

    for kind in cfg.kinds:
        occ = len(cfg.kind_positions(kind)) * cfg.n_repeat
        mixer, ffn = kind.split("+")
        leaves: dict = {}
        if mixer in ("attn", "swa"):
            clen = _cache_len(cfg, mixer, max_seq)
            leaves["k"] = torch.zeros((occ, batch, clen, kv, hd), dtype=dtype,
                                      device=dev)
            leaves["v"] = torch.zeros((occ, batch, clen, kv, hd), dtype=dtype,
                                      device=dev)
            leaves["slot_pos"] = torch.full((occ, clen), -1,
                                            dtype=torch.int32, device=dev)
        elif mixer == "mamba":
            conv, hst = init_mamba_state(cfg, batch, dtype, device=dev)
            leaves["conv"], leaves["h"] = stack(conv, occ), stack(hst, occ)
        elif mixer == "rwkv":
            xa, sst, xc = init_rwkv_state(cfg, batch, dtype, device=dev)
            leaves["xa"], leaves["S"] = stack(xa, occ), stack(sst, occ)
            leaves["xc"] = stack(xc, occ)
        if ffn == "cmix" and "xc" not in leaves:
            leaves["xc"] = torch.zeros((occ, batch, cfg.d_model), dtype=dtype,
                                       device=dev)
        if cfg.is_encdec:
            for name in ("xk", "xv"):
                leaves[name] = torch.zeros(
                    (occ, batch, cfg.encoder_seq, nh, hd), dtype=dtype,
                    device=dev)
        caches[kind] = leaves
    return caches


def _sharded_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   dev: torch.device, rules) -> dict:
    """``init_cache``'s leaves as ``DTensor``s, each rank holding only its
    shard: every leaf starts at zero but ``slot_pos`` (-1)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..sharding.collectives import as_dtensor
    with FakeTensorMode():       # the whole leaves' shapes, nothing allocated
        whole = init_cache(cfg, batch, max_seq, dtype=dtype, device="cpu")
    axes = cache_logical_axes(cfg)
    out = {}
    for kind, leaves in whole.items():
        out[kind] = {}
        for name, t in leaves.items():
            ax = axes[kind][name]
            shape = rules.local_shape(t.shape, rules.spec(ax, t.shape))
            local = torch.full(shape, -1 if name == "slot_pos" else 0,
                               dtype=t.dtype, device=dev)
            out[kind][name] = as_dtensor(local, rules, ax, tuple(t.shape))
    return out


def _ring_lens(caches) -> dict:
    """Kind -> the slots of its KV caches' ring (a ``DTensor``'s global
    length, which its local shard may not hold)."""
    return {kind: leaves["k"].shape[2] for kind, leaves in caches.items()
            if "k" in leaves}


def _local_caches(caches, shards: Shards | None):
    """Sharded, the caches' local shards (written in place)."""
    if shards is None:
        return caches
    return {kind: {name: t.to_local() for name, t in leaves.items()}
            for kind, leaves in caches.items()}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, caches, *, frontend=None,
            frames=None, shards: Shards | None = None):
    """Full-sequence forward that fills the caches (in place); returns
    (last-token logits (B, 1, V), caches).  With ``shards``, one rank's
    part of a sharded prefill: ``tokens`` (and ``frontend``/``frames``)
    are this rank's rows, ``params`` and ``caches`` its ``DTensor`` shards,
    and the logits the ``DTensor`` of the global ones."""
    enc_out, h = _start(params, cfg, tokens, frontend, frames,
                        shards=shards)
    s = h.shape[1]
    sin, cos = _rope_tables(cfg, torch.arange(s, device=h.device))
    ctx = Ctx(mode="prefill", sin=sin, cos=cos,
              prefix_len=cfg.frontend_tokens, enc_out=enc_out, shards=shards,
              ring=_ring_lens(caches))
    h = _run_blocks(cfg, params["blocks"], _local_caches(caches, shards), h,
                    ctx)
    h = _norm(h, _w(shards, params["final_norm"]), cfg)
    return _logits(params, cfg, h[:, -1:], shards), caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, caches, pos: int, *,
                shards: Shards | None = None):
    """One decode step: token (B, 1) int, ``pos`` the new token's position
    -> (logits (B, 1, V), caches updated in place).  With ``shards``, as
    ``prefill``'s: ``token`` is this rank's rows."""
    pos = int(pos)
    h = _embed(params, cfg, token, shards=shards)
    if cfg.is_encdec:
        h = h + _w(shards, params["dec_pos_emb"])[None, pos:pos + 1].to(
            h.dtype)
    # arange, not a tensor from a list: no host-to-device copy in the step
    sin, cos = _rope_tables(cfg, torch.arange(pos, pos + 1, device=h.device))
    ctx = Ctx(mode="decode", sin=sin, cos=cos, pos=pos, shards=shards,
              ring=_ring_lens(caches))
    h = _run_blocks(cfg, params["blocks"], _local_caches(caches, shards), h,
                    ctx)
    h = _norm(h, _w(shards, params["final_norm"]), cfg)
    return _logits(params, cfg, h, shards), caches
