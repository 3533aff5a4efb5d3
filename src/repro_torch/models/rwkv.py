"""RWKV6 ("Finch") mixer: linear attention with data-dependent diagonal
decay, plus RWKV channel-mix.

Prefill and the full forward use the *chunked* WKV formulation: within a
chunk of C tokens, with per-step decay vectors ``w_t ∈ (0,1)^hd`` and
cumulative log-decay ``L_t = Σ_{τ<=t} log w_τ``,

  y_t = (r_t ⊙ e^{L_{t-1}}) · S_in                       (inter-chunk)
      + Σ_{j<t} [(r_t ⊙ e^{L_{t-1}}) · (k_j ⊙ e^{-L_j})] v_j   (intra)
      + (r_t ⊙ u ⊙ k_t) · v_t                            (bonus diagonal)
  S_out = diag(e^{L_C}) S_in + Σ_j (k_j ⊙ e^{L_C - L_j}) v_jᵀ

The e^{-L_j} factor is clipped at e^{CLIP}.  The chunk is the largest
divisor of S that is <= ``CHUNK``, so a prime S runs chunks of one token.
The token shift and the five mixes run in the input's dtype; the decay, the
WKV chunks and the per-head group norm in f32.

Decode is the same mixer on one token: S_t = diag(w_t) S_{t-1} + k_t v_tᵀ.

Sharded over "model" (``act_heads``), a rank runs its heads
[h0, h0 + nh): its columns of the r/k/v/g projections and of the
low-rank decay's output (and of ``w_base``), its rows of ``u`` and of the
per-head group norm; ``wo``'s rows give a partial sum over "model".  The
WKV state cache is whole on every rank, so the rank reads its heads' part
and all-gathers the new state over "model".  The token shift and the
mixes run alike on every rank.  The time mix's weights rest whole on every
rank of "model", so under a gradient they and ``x`` enter the rank's part
through ``Shards.enter`` (training keeps no WKV state to gather).  The
channel mix's ``cm_k``/``cm_v`` are split over ``mlp``, so its value
product is a partial sum over "model"; its key input enters the rank's
part, while its receptance (``cm_r``) runs alike on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .attention import _fit
from .config import ModelConfig
from .layers import checkpointed, rms_norm

__all__ = ["rwkv_mixer", "rwkv_decode", "rwkv_channel_mix",
           "init_rwkv_state", "CHUNK"]

# CHUNK x max|log w| must stay inside f32 exponent range: with the decay
# exponent clamped at 1.0 (per-step log-decay >= -e = -2.72), |L| <= 43.5
# over a 16-token chunk, so e^{±L} is representable in f32.
CHUNK = 16
CLIP = 44.0
_WEIGHTS = ("mu", "w_base", "w_lora_a", "w_lora_b", "wr", "wk", "wv", "wg",
            "u", "ln_x", "wo")


def _clip(x, lo, hi):
    """``jnp.clip``: minimum(maximum(x, lo), hi), whose gradient is split
    in half where x equals a bound (``torch.clamp`` passes all of it; the
    init's ``w_base`` reaches the upper bound 1.0 exactly)."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    return torch.minimum(x, x.new_full((), hi))


def _proj(x, w, dt):
    return x @ w.to(dt)


def _mix_heads(x: torch.Tensor, x_prev: torch.Tensor, p: dict,
               cfg: ModelConfig):
    """Token-shift mixing + projections -> per-head r, k, v, g, log-decay
    (of the heads whose columns ``p`` holds)."""
    dt = x.dtype
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = p["wr"].shape[1] // hd
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    mu = p["mu"].to(dt)                                      # (5, D)
    xs = [x + mu[i] * (shifted - x) for i in range(5)]       # r k v w g
    r = _proj(xs[0], p["wr"], dt).reshape(b, s, h, hd)
    k = _proj(xs[1], p["wk"], dt).reshape(b, s, h, hd)
    v = _proj(xs[2], p["wv"], dt).reshape(b, s, h, hd)
    # data-dependent decay (low-rank): w = exp(-exp(base + tanh(x A) B))
    wl = xs[3].float() @ p["w_lora_a"].float()
    wl = torch.tanh(wl) @ p["w_lora_b"].float()
    logw = -torch.exp(
        _clip(p["w_base"].float() + wl, -8.0, 1.0)
    ).reshape(b, s, h, hd)                                   # log w_t < 0
    g = F.silu(_proj(xs[4], p["wg"], dt))                    # (B,S,D)
    return r, k, v, logw, g


def _wkv_chunk(s_in, r, k, v, logw, u):
    """One chunk; r/k/v (B,H,C,hd) f32, logw (B,H,C,hd), u (H,hd),
    s_in (B,H,hd,hd).  Returns (s_out, y (B,H,C,hd))."""
    c = r.shape[2]
    lcum = torch.cumsum(logw, dim=2)                         # L_t (incl. t)
    lprev = lcum - logw                                      # L_{t-1}
    r_t = r * torch.exp(lprev)
    k_t = k * torch.exp(_clip(-lcum, None, CLIP))
    a = r_t @ k_t.transpose(-1, -2)                          # (B,H,C,C)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    a = torch.where(mask, a, 0.0)
    # bonus diagonal: (r_t ⊙ u ⊙ k_t)·v_t
    diag = (r * u[None, :, None, :] * k).sum(-1)             # (B,H,C)
    y = r_t @ s_in + a @ v + diag[..., None] * v
    ltot = lcum[:, :, -1:, :]                                # L_C
    k_s = k * torch.exp(ltot - lcum)
    s_out = (torch.exp(ltot.squeeze(2))[..., None] * s_in
             + k_s.transpose(-1, -2) @ v)
    return s_out, y


def _local(p: dict, h0: int, nh: int, hd: int) -> dict:
    """The time mix's params for heads [h0, h0 + nh)."""
    if nh == p["u"].shape[0]:
        return p
    cols = slice(h0 * hd, (h0 + nh) * hd)
    return dict(p, wr=p["wr"][:, cols], wk=p["wk"][:, cols],
                wv=p["wv"][:, cols], wg=p["wg"][:, cols],
                w_lora_b=p["w_lora_b"][:, cols], w_base=p["w_base"][cols],
                u=p["u"][h0:h0 + nh], ln_x=p["ln_x"][cols],
                wo=p["wo"][cols])


def rwkv_mixer(
    x: torch.Tensor,              # (B, S, D)
    p: dict,
    cfg: ModelConfig,
    state: tuple | None = None,   # (x_prev (B,D), S (B,H,hd,hd))
    return_state: bool = False,
    shards=None,                  # sharded serving: this rank's part
):
    b, s, d = x.shape
    hs, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    h0, h = (0, hs) if shards is None else shards.local("act_heads", hs)
    if h < hs:                       # into this rank's heads
        x, p = shards.enter(x), shards.enter_all(p, _WEIGHTS)
    p = _local(p, h0, h, hd)
    x_prev = state[0] if state is not None else x.new_zeros((b, d))
    s_st = (state[1][:, h0:h0 + h] if state is not None else
            torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device))
    r, k, v, logw, g = _mix_heads(x, x_prev, p, cfg)

    chunk = _fit(s, CHUNK)
    u = p["u"].float()
    rf, kf, vf, wf = (t.float().transpose(1, 2)
                      for t in (r, k, v, logw))              # (B,H,S,hd)
    ys = []
    for c0 in range(0, s, chunk):
        # recomputed per chunk in the backward, as the reference's
        s_st, y = checkpointed(_wkv_chunk, s_st, *(t[:, :, c0:c0 + chunk]
                                                   for t in (rf, kf, vf, wf)),
                               u)
        ys.append(y)
    y = torch.cat(ys, dim=2).transpose(1, 2)                 # (B,S,H,hd)
    # per-head group norm, then gate and output projection
    y = rms_norm(y, p["ln_x"].reshape(h, hd), cfg.norm_eps).reshape(
        b, s, h * hd)
    y = (y * g).to(x.dtype)
    w = p["wo"].to(x.dtype)
    # sharded, a partial sum of this rank's heads
    out = shards.dot(y, w) if h < hs else y @ w
    if return_state:
        if h < hs:                   # the cache holds every head's state
            s_st = shards.gather(s_st, "model", 1)
        return out, (x[:, -1, :], s_st)
    return out


def rwkv_decode(x, p, cfg, state):
    return rwkv_mixer(x, p, cfg, state=state, return_state=True)


def rwkv_channel_mix(
    x: torch.Tensor, p: dict, cfg: ModelConfig,
    state: torch.Tensor | None = None,    # x_prev (B, D)
    return_state: bool = False,
    shards=None,                  # sharded serving: this rank's part
):
    b, s, d = x.shape
    dt = x.dtype
    x_prev = state if state is not None else x.new_zeros((b, d))
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    mu = p["cm_mu"].to(dt)
    xk = x + mu[0] * (shifted - x)
    xr = x + mu[1] * (shifted - x)
    w = p["cm_v"].to(dt)
    split = w.shape[0] < cfg.d_ff
    if split:                        # into this rank's hidden columns
        xk = shards.enter(xk)
    kk = torch.square(torch.relu(xk @ p["cm_k"].to(dt)))
    # split over "mlp", a partial sum of this rank's rows
    vv = shards.dot(kk, w) if split else kk @ w
    rr = torch.sigmoid(xr @ p["cm_r"].to(dt))
    out = rr * vv
    if return_state:
        return out, x[:, -1, :]
    return out


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = None):
    """Zero (attn x_prev (B, D), wkv state (B, H, hd, hd) f32, cmix x_prev
    (B, D)) on ``device`` (default: the card)."""
    device = resolve_device(device)
    h, hd, d = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    return (
        torch.zeros((batch, d), dtype=dtype, device=device),
        torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, d), dtype=dtype, device=device),
    )
