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
the train step (``train.build_train_step(..., rules=)``) gathers the whole
param tree before calling ``loss_fn`` (the JAX package's FSDP
gather-at-use, ``_gather_fsdp``, done once per step instead of per layer)
and reduce-scatters the gradients itself.
``jax.checkpoint`` maps to ``torch.utils.checkpoint`` (``layers.checkpointed``)
at the same places: a repeat of ``cfg.pattern`` under ``remat``, each loss
chunk, each attention query chunk, each MoE token group, each mamba and
rwkv chunk.  The serving entry points run without a gradient; ``loss_fn``
records one.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import DeviceLike, resolve_device
from .attention import decode_attention, flash_attention
from .config import ModelConfig
from .layers import (COMPUTE_DTYPE, checkpointed, mlp, nonparam_norm,
                     rms_norm, rope, rope_table)
from .mamba import init_mamba_state, mamba_mixer
from .moe import moe_ffn
from .rwkv import init_rwkv_state, rwkv_channel_mix, rwkv_mixer

__all__ = ["forward", "loss_fn", "prefill", "decode_step", "init_cache",
           "encode_audio"]


@dataclasses.dataclass
class Ctx:
    mode: str                         # "full" | "prefill" | "decode"
    sin: torch.Tensor | None = None   # rope tables for the current positions
    cos: torch.Tensor | None = None
    pos: int = 0                      # decode: position of the new token
    prefix_len: int = 0
    enc_out: torch.Tensor | None = None   # encdec: encoder activations
    causal: bool = True


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
    mixer = kind.split("+")[0]
    window = cfg.sliding_window if mixer == "swa" else 0
    b, s, d = h.shape
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = h.dtype
    x = _norm(h, p["norm1"], cfg)
    q = (x @ p["wq"].to(dt)).reshape(b, s, nh, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, s, kv, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, s, kv, hd)
    q = _qk_headnorm(q, p, cfg, "q_norm")
    k = _qk_headnorm(k, p, cfg, "k_norm")
    if cfg.rope_theta > 0:
        q = rope(q, ctx.sin, ctx.cos)
        k = rope(k, ctx.sin, ctx.cos)

    if ctx.mode == "decode":
        clen = cache["k"].shape[1]
        slot = ctx.pos % clen
        cache["k"][:, slot:slot + 1] = k.to(cache["k"].dtype)
        cache["v"][:, slot:slot + 1] = v.to(cache["v"].dtype)
        cache["slot_pos"][slot] = ctx.pos
        o = decode_attention(q, cache["k"], cache["v"], cache["slot_pos"],
                             ctx.pos, window=window)
    else:
        o = flash_attention(q, k, v, causal=ctx.causal, window=window,
                            prefix_len=ctx.prefix_len)
        if ctx.mode == "prefill":
            clen = cache["k"].shape[1]
            keep = min(s, clen)
            pos_keep = torch.arange(keep, device=h.device) + (s - keep)
            slots = pos_keep % clen
            cache["k"][:, slots] = k[:, s - keep:].to(cache["k"].dtype)
            cache["v"][:, slots] = v[:, s - keep:].to(cache["v"].dtype)
            cache["slot_pos"][slots] = pos_keep.to(cache["slot_pos"].dtype)

    out = o.reshape(b, s, nh * hd) @ p["wo"].to(dt)
    return h + out


def _cross_mixer(h, p, cfg: ModelConfig, ctx: Ctx, cache):
    """Whisper decoder cross-attention over encoder outputs."""
    b, s, d = h.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    dt = h.dtype
    x = _norm(h, p["norm_x"], cfg)
    q = (x @ p["xwq"].to(dt)).reshape(b, s, nh, hd)
    if ctx.mode == "decode":
        xk, xv = cache["xk"], cache["xv"]
        sp = torch.arange(xk.shape[1], dtype=torch.int32, device=h.device)
        o = decode_attention(q, xk, xv, sp, 2**30)
    else:
        enc = ctx.enc_out
        xk = (enc @ p["xwk"].to(dt)).reshape(b, enc.shape[1], nh, hd)
        xv = (enc @ p["xwv"].to(dt)).reshape(b, enc.shape[1], nh, hd)
        o = flash_attention(q, xk, xv, causal=False)
        if ctx.mode == "prefill":
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
    out = o.reshape(b, s, nh * hd) @ p["xwo"].to(dt)
    return h + out


def _apply_block(kind, h, p, cfg: ModelConfig, ctx: Ctx, cache):
    """One layer; a recurrent mixer's new state is copied into its cache
    views (rebinding a key of ``cache`` would lose it)."""
    mixer, ffn = kind.split("+")
    if mixer in ("attn", "swa"):
        h = _attention_mixer(kind, h, p, cfg, ctx, cache)
    elif mixer == "mamba":
        x = _norm(h, p["norm1"], cfg)
        if ctx.mode == "full":
            h = h + mamba_mixer(x, p, cfg)
        else:
            out, (conv, hst) = mamba_mixer(
                x, p, cfg, state=(cache["conv"], cache["h"]),
                return_state=True)
            h = h + out
            cache["conv"].copy_(conv)
            cache["h"].copy_(hst)
    elif mixer == "rwkv":
        x = _norm(h, p["norm1"], cfg)
        if ctx.mode == "full":
            h = h + rwkv_mixer(x, p, cfg)
        else:
            out, (xa, sst) = rwkv_mixer(
                x, p, cfg, state=(cache["xa"].to(x.dtype), cache["S"]),
                return_state=True)
            h = h + out
            cache["xa"].copy_(xa)
            cache["S"].copy_(sst)
    else:
        raise ValueError(mixer)

    if cfg.is_encdec:
        h = _cross_mixer(h, p, cfg, ctx, cache)

    x = _norm(h, p["norm2"], cfg)
    if ffn == "mlp":
        h = h + mlp(x, p, cfg.mlp_act)
    elif ffn == "moe":
        # as the reference (``repro/models/lm.py:194``): no router bits are
        # passed, so a model configured with router="tcam_dt" fails moe_ffn's
        # assertion; the TCAM router is reached through moe_ffn directly
        h = h + moe_ffn(x, p, cfg)
    elif ffn == "cmix":
        if ctx.mode == "full":
            h = h + rwkv_channel_mix(x, p, cfg)
        else:
            out, xc = rwkv_channel_mix(x, p, cfg,
                                       state=cache["xc"].to(x.dtype),
                                       return_state=True)
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
            p_i = {name: a[idx] for name, a in blocks[kind].items()}
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
def _embed(params, cfg: ModelConfig, tokens, frontend=None):
    table = params["embed"]
    tokens = torch.as_tensor(tokens, device=table.device).long()
    h = table[tokens].to(COMPUTE_DTYPE)
    if cfg.emb_scale:
        # sqrt(d_model) is rounded to bf16 before the multiply, as there
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=COMPUTE_DTYPE,
                             device=h.device)
    if frontend is not None:
        frontend = torch.as_tensor(frontend, device=h.device)
        h = torch.cat([frontend.to(COMPUTE_DTYPE), h], dim=1)
    return h


def _logits(params, cfg: ModelConfig, h):
    return h @ _head(params, cfg).to(h.dtype)


def _rope_tables(cfg: ModelConfig, positions):
    if cfg.rope_theta <= 0:
        return None, None
    return rope_table(positions, cfg.head_dim, cfg.rope_theta)


def _encode(params, cfg: ModelConfig, frames, remat: str):
    enc = params["encoder"]
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass frames=")
    frames = torch.as_tensor(frames, device=enc["pos_emb"].device)
    h = frames.to(COMPUTE_DTYPE) + enc["pos_emb"][None].to(COMPUTE_DTYPE)
    cfg_enc = dataclasses.replace(cfg, encoder_layers=0,
                                  n_layers=cfg.encoder_layers,
                                  pattern=("attn+mlp",))
    sin, cos = _rope_tables(cfg, torch.arange(h.shape[1], device=h.device))
    ctx = Ctx(mode="full", sin=sin, cos=cos, causal=False)
    h = _run_blocks(cfg_enc, enc["blocks"], None, h, ctx, remat=remat)
    return _norm(h, enc["final_norm"], cfg)


@torch.no_grad()
def encode_audio(params, cfg: ModelConfig, frames):
    """Whisper encoder: frames are stub frontend embeddings (B, S_enc, D);
    non-causal ``attn+mlp`` blocks without cross-attention, then the
    encoder's final norm."""
    return _encode(params, cfg, frames, "none")


def _start(params, cfg: ModelConfig, tokens, frontend, frames,
           remat: str = "none"):
    """The encoder's output (encoder-decoder only) and the embedded tokens
    with the decoder's positions added."""
    enc_out = (_encode(params, cfg, frames, remat) if cfg.is_encdec
               else None)
    h = _embed(params, cfg, tokens, frontend)
    if cfg.is_encdec:
        h = h + params["dec_pos_emb"][None, :h.shape[1]].to(h.dtype)
    return enc_out, h


def _hidden(params, cfg: ModelConfig, tokens, frontend, frames,
            remat: str = "none"):
    """The final-normed hidden states (B, S, D) of the full sequence."""
    enc_out, h = _start(params, cfg, tokens, frontend, frames, remat)
    s = h.shape[1]
    sin, cos = _rope_tables(cfg, torch.arange(s, device=h.device))
    ctx = Ctx(mode="full", sin=sin, cos=cos, prefix_len=cfg.frontend_tokens,
              enc_out=enc_out)
    h = _run_blocks(cfg, params["blocks"], None, h, ctx, remat=remat)
    return _norm(h, params["final_norm"], cfg)


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


@torch.no_grad()
def forward(params, cfg: ModelConfig, tokens, *, frontend=None, frames=None):
    """Full-sequence activations -> logits (B, S, V) in bf16; an
    encoder-decoder takes its encoder's input as ``frames``."""
    return _logits(params, cfg, _hidden(params, cfg, tokens, frontend,
                                        frames))


def _chunk_loss(hc, lc, w):
    """Summed next-token cross-entropy of one chunk, and its label count."""
    logits = (hc @ w.to(hc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc.clamp_min(0)[..., None])[..., 0]
    valid = lc >= 0
    return ((lse - gold) * valid).sum(), valid.sum(dtype=torch.int32)


def loss_fn(params, cfg: ModelConfig, batch, *, remat: str = "dots",
            loss_chunk: int = 1024):
    """Next-token CE with seq-chunked logits (peak memory ~ B x chunk x V);
    labels of -1 (and a multimodal prefix's positions) carry no loss.
    Records the graph for a backward pass; each chunk's logits are
    recomputed there.  ``batch`` holds ``tokens`` and ``labels`` (B, S_text)
    and, per configuration, ``patches`` or ``frames``.  Returns
    (loss, {"loss", "tokens"})."""
    h = _hidden(params, cfg, batch["tokens"], batch.get("patches"),
                batch.get("frames"), remat)
    labels = torch.as_tensor(batch["labels"], device=h.device).long()
    if cfg.frontend_tokens:
        # frontend positions carry no next-token loss
        pad = labels.new_full((labels.shape[0], cfg.frontend_tokens), -1)
        labels = torch.cat([pad, labels], dim=1)
    w = _head(params, cfg)
    s = h.shape[1]
    chunk = min(loss_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk "
                         f"{chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    for c0 in range(0, s, chunk):
        loss, n = checkpointed(_chunk_loss, h[:, c0:c0 + chunk],
                               labels[:, c0:c0 + chunk], w)
        tot, cnt = tot + loss, cnt + n
    loss = tot / torch.clamp_min(cnt, 1)
    return loss, {"loss": loss, "tokens": cnt}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               dtype: torch.dtype = COMPUTE_DTYPE,
               device: DeviceLike = None) -> dict:
    """Stacked per-kind decode caches on ``device`` (default: the card)."""
    dev = resolve_device(device)
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


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, caches, *, frontend=None,
            frames=None):
    """Full-sequence forward that fills the caches (in place); returns
    (last-token logits (B, 1, V), caches)."""
    enc_out, h = _start(params, cfg, tokens, frontend, frames)
    s = h.shape[1]
    sin, cos = _rope_tables(cfg, torch.arange(s, device=h.device))
    ctx = Ctx(mode="prefill", sin=sin, cos=cos,
              prefix_len=cfg.frontend_tokens, enc_out=enc_out)
    h = _run_blocks(cfg, params["blocks"], caches, h, ctx)
    h = _norm(h, params["final_norm"], cfg)
    return _logits(params, cfg, h[:, -1:]), caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, caches, pos: int):
    """One decode step: token (B, 1) int, ``pos`` the new token's position
    -> (logits (B, 1, V), caches updated in place)."""
    pos = int(pos)
    h = _embed(params, cfg, token)
    if cfg.is_encdec:
        h = h + params["dec_pos_emb"][None, pos:pos + 1].to(h.dtype)
    # arange, not a tensor from a list: no host-to-device copy in the step
    sin, cos = _rope_tables(cfg, torch.arange(pos, pos + 1, device=h.device))
    ctx = Ctx(mode="decode", sin=sin, cos=cos, pos=pos)
    h = _run_blocks(cfg, params["blocks"], caches, h, ctx)
    h = _norm(h, params["final_norm"], cfg)
    return _logits(params, cfg, h), caches
