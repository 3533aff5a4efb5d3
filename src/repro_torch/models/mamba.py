"""Mamba selective-SSM mixer (jamba's attention-free layers).

Prefill and the full forward run a *chunked* selective scan: the sequence is
processed in chunks carrying the (B, d_inner, N) state; inside a chunk the
recurrence is a plain time loop.  The chunk bounds the materialized
(B, chunk, d_inner, N) discretized tensors — the full-sequence
(B, S, d_inner, N) form would be tens of GB at 4k+ sequence lengths; the
backward recomputes one chunk at a time.  The
chunk is the largest divisor of S that is <= ``CHUNK``, so a prime S runs
chunks of one token.

The conv accumulates in f32 and the scan runs in f32; both return the
input's dtype.  Decode is the single-token state update.

Sharded over "model" (``act_dinner``), a rank runs its columns
[d0, d0 + nd) of the inner dim: its columns of both halves of
``in_proj``, its rows of the conv, ``A_log``, ``Dskip`` and ``dt_b``, its
columns of ``dt_w``; ``x_proj`` contracts over the inner dim, so the
(dt, B, C) projection is all-reduced in f32 before it is split, and
``out_proj``'s rows give a partial sum over "model".  Its conv and SSM
state are its columns' (the caches' ``act_dinner`` shards).  The mixer's
weights rest whole on every rank of "model", so under a gradient they
and ``x`` enter the rank's part through ``Shards.enter``, and so does the
summed (dt, B, C) projection, which feeds the rank's columns again.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .attention import _fit
from .config import ModelConfig
from .layers import checkpointed

__all__ = ["mamba_mixer", "mamba_decode", "init_mamba_state", "CHUNK"]

CHUNK = 256
_WEIGHTS = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A_log",
            "Dskip", "out_proj")


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along seq.  x (B,S,Di), w (Di,K), b (Di,);
    prev (B,K-1,Di) carries context across prefill->decode."""
    bsz, s, di = x.shape
    k = w.shape[1]
    if prev is None:
        prev = x.new_zeros((bsz, k - 1, di))
    xp = torch.cat([prev, x], dim=1)                        # (B, S+K-1, Di)
    out = torch.zeros((bsz, s, di), dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * w[:, i].float()
    return (out + b.float()).to(x.dtype)


def _ssm_chunk(h0: torch.Tensor, dA: torch.Tensor, dBx: torch.Tensor,
               cmat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the recurrence h_t = dA_t * h_{t-1} + dBx_t.

    h0 (B, Di, N); dA/dBx (B, C, Di, N); cmat (B, C, N).
    Returns (h_final, y (B, C, Di))."""
    h = h0
    ys = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]                        # (B, Di, N)
        ys.append((h @ cmat[:, t, :, None])[..., 0])        # (B, Di)
    return h, torch.stack(ys, dim=1)


def _ssm(x: torch.Tensor, p: dict, cfg: ModelConfig,
         h0: torch.Tensor | None = None, xdb_sum=None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan over the full sequence in chunks.
    x (B, S, Di) post-conv activations; returns (y (B,S,Di), h_final).
    ``xdb_sum`` adds up the (dt, B, C) projection of a rank's columns of
    the inner dim over the ranks."""
    bsz, s, di = x.shape
    n = cfg.ssm_state
    dtr = cfg.dt_rank
    xf = x.float()

    xdb = xf @ p["x_proj"].float()
    if xdb_sum is not None:
        xdb = xdb_sum(xdb)
    dt, bmat, cmat = torch.split(xdb, [dtr, n, n], dim=-1)
    dt = F.softplus(dt @ p["dt_w"].float() + p["dt_b"].float())  # (B, S, Di)
    a = -torch.exp(p["A_log"].float())                             # (Di, N)

    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    chunk = _fit(s, CHUNK)

    def outer(h, dt_c, b_c, c_c, x_c):
        da = torch.exp(dt_c[..., None] * a)                 # (B,C,Di,N)
        dbx = dt_c[..., None] * b_c[:, :, None, :] * x_c[..., None]
        return _ssm_chunk(h, da, dbx, c_c)

    ys = []
    for c0 in range(0, s, chunk):
        # recomputed per chunk in the backward: without it autograd keeps
        # every time step's (B, Di, N) state
        h, y = checkpointed(outer, h, *(t[:, c0:c0 + chunk]
                                        for t in (dt, bmat, cmat, xf)))
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + xf * p["Dskip"].float()
    return y.to(x.dtype), h


def _local(p: dict, d0: int, nd: int) -> dict:
    """The mixer's params for inner-dim columns [d0, d0 + nd)."""
    di = p["conv_w"].shape[0]
    if nd == di:
        return p
    cols = slice(d0, d0 + nd)
    return dict(
        p, in_proj=torch.cat([p["in_proj"][:, cols],
                              p["in_proj"][:, di + d0:di + d0 + nd]], dim=1),
        conv_w=p["conv_w"][cols], conv_b=p["conv_b"][cols],
        x_proj=p["x_proj"][cols], dt_w=p["dt_w"][:, cols],
        dt_b=p["dt_b"][cols], A_log=p["A_log"][cols],
        Dskip=p["Dskip"][cols], out_proj=p["out_proj"][cols])


def mamba_mixer(
    x: torch.Tensor,              # (B, S, D) post-norm residual stream
    p: dict,
    cfg: ModelConfig,
    state: tuple | None = None,   # (conv_prev (B,K-1,Di), h (B,Di,N))
    return_state: bool = False,
    shards=None,                  # sharded serving: this rank's part
):
    dt = x.dtype
    di = p["conv_w"].shape[0]
    d0, nd = (0, di) if shards is None else shards.local("act_dinner", di)
    split = nd < di
    if split:                        # into this rank's inner-dim columns
        x, p = shards.enter(x), shards.enter_all(p, _WEIGHTS)
    p = _local(p, d0, nd)
    xz = x @ p["in_proj"].to(dt)
    xin, z = xz.chunk(2, dim=-1)                            # (B,S,Di) each
    conv_prev = state[0] if state is not None else None
    h0 = state[1] if state is not None else None
    xc = F.silu(_conv_causal(xin, p["conv_w"], p["conv_b"], conv_prev))
    y, h = _ssm(xc, p, cfg, h0, xdb_sum=(
        (lambda t: shards.enter(shards.sum(t, "model"))) if split else None))
    y = y * F.silu(z)
    w = p["out_proj"].to(dt)
    # sharded, a partial sum of this rank's columns
    out = shards.dot(y, w) if split else y @ w
    if return_state:
        k = cfg.ssm_conv
        if conv_prev is None:
            conv_prev = xin.new_zeros((x.shape[0], k - 1, xin.shape[-1]))
        hist = torch.cat([conv_prev, xin], dim=1)           # (B, S+K-1, Di)
        new_conv = hist[:, hist.shape[1] - (k - 1):]
        return out, (new_conv, h)
    return out


def init_mamba_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None):
    """Zero (conv (B, K-1, Di) in ``dtype``, h (B, Di, N) f32) on ``device``
    (default: the card)."""
    device = resolve_device(device)
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return (
        torch.zeros((batch, k - 1, di), dtype=dtype, device=device),
        torch.zeros((batch, di, n), dtype=torch.float32, device=device),
    )


def mamba_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, state: tuple):
    """Single-token decode: x (B, 1, D) -> (out (B,1,D), new state)."""
    return mamba_mixer(x, p, cfg, state=state, return_state=True)
