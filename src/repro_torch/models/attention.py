"""Attention: chunked online-softmax ("flash" in plain tensor ops) for
forward/prefill, plus a single-query decode path over KV caches (full or
sliding-window ring).

The chunked formulation never materializes the (Sq, Sk) score matrix —
peak memory is O(q_chunk · kv_chunk) per head group, in the backward too
(each query chunk is recomputed there).  Scores, softmax statistics and the
accumulator are f32 whatever the operands' dtype.

Known waste (kept for parity with the reference): causal masking is applied
to full block products, so causal attention executes ~2x the minimal FLOPs;
triangular block scheduling is later performance work.
"""
from __future__ import annotations

import torch

from .layers import checkpointed

NEG_INF = -1e30

__all__ = ["flash_attention", "decode_attention", "NEG_INF"]


def _fit(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is <= ``want``."""
    c = min(want, n)
    while n % c:
        c -= 1
    return c


def flash_attention(
    q: torch.Tensor,         # (B, Sq, H, hd)
    k: torch.Tensor,         # (B, Sk, KV, hd)
    v: torch.Tensor,         # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,         # >0: sliding-window attention
    q_offset: int = 0,       # absolute position of q[0] (prefill continuation)
    prefix_len: int = 0,     # bidirectional prefix (paligemma image tokens)
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    assert h % kv == 0, (h, kv)
    g = h // kv
    q_chunk = _fit(sq, q_chunk)
    kv_chunk = _fit(sk, kv_chunk)
    nk = sk // kv_chunk
    scale = hd ** -0.5
    dev = q.device

    def q_step(qi, q0, k, v):
        """One query chunk against every key chunk (online softmax)."""
        qi = qi.reshape(b, q_chunk, kv, g, hd).float()
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((b, q_chunk, kv, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, q_chunk, kv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, q_chunk, kv, g, hd), dtype=torch.float32,
                          device=dev)
        for kj_idx in range(nk):
            k0 = kj_idx * kv_chunk
            kj = k[:, k0:k0 + kv_chunk].float()
            vj = v[:, k0:k0 + kv_chunk].float()
            kv_pos = k0 + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgh,bskh->bqkgs", qi, kj) * scale
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                c = kv_pos[None, :] <= q_pos[:, None]
                if prefix_len > 0:
                    c |= kv_pos[None, :] < prefix_len
                mask &= c
            if window > 0:
                w = kv_pos[None, :] > q_pos[:, None] - window
                if prefix_len > 0:
                    w |= kv_pos[None, :] < prefix_len
                mask &= w
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgs,bskh->bqkgh", p, vj)
            m = m_new
            del s, p   # free this step's score blocks before the next's
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        return o.reshape(b, q_chunk, h, hd).to(q.dtype)

    # Each query chunk is recomputed in the backward (as the reference's
    # jax.checkpoint): the backward's peak is one chunk's scores, not Sq x Sk.
    return torch.cat([
        checkpointed(q_step, q[:, q0:q0 + q_chunk], q0, k, v)
        for q0 in range(0, sq, q_chunk)], dim=1)


def _as_is(t: torch.Tensor) -> torch.Tensor:
    return t


def decode_attention(
    q: torch.Tensor,         # (B, 1, H, hd) — one new token
    cache_k: torch.Tensor,   # (B, S, KV, hd) — RoPE applied at write time
    cache_v: torch.Tensor,   # (B, S, KV, hd)
    slot_pos: torch.Tensor,  # (S,) int32 absolute position per slot, -1 empty
    pos: int,                # position of the new token
    *,
    window: int = 0,
    scale: float | None = None,   # default hd ** -0.5
    scores_sum=None,         # sums partial scores over the ranks sharing hd
    seq_max=_as_is,          # over the ranks holding the other cache slots:
    seq_sum=_as_is,          # their max, and their sum in f32
) -> torch.Tensor:
    """One query token against the cache.  Sharded over ``head_dim``
    (``q`` and the caches hold this rank's columns of it), the products
    over the local columns are partial scores, which ``scores_sum`` adds
    up over the ranks before the softmax; ``scale`` is then the whole head
    dim's.  The output holds the same columns.

    Sharded over the sequence (the caches and ``slot_pos`` hold this
    rank's stretch of the slots), the softmax is still the global one:
    ``seq_max`` reduces the scores' max, ``seq_sum`` the sum of their
    exponentials and then the probability-weighted values, so the
    probabilities are rounded to the cache's dtype after the global
    normalisation, as unsharded.  Left as they are, the two hooks give
    the unsharded arithmetic."""
    b, _, h, hd = q.shape
    _, s, kv, _ = cache_k.shape
    g = h // kv
    if scale is None:
        scale = hd ** -0.5
    # The reference multiplies the storage-dtype (bf16) operands with f32
    # accumulation.  A bf16 x bf16 product is exact in f32, so f32 operands
    # give the same f32 scores; the probabilities are rounded to the cache's
    # dtype before the second product, as there.
    qg = q.reshape(b, kv, g, hd).float()
    s_ = torch.einsum("bkgh,bskh->bkgs", qg, cache_k.float())
    if scores_sum is not None:
        s_ = scores_sum(s_)
    s_ = s_ * scale
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        valid &= slot_pos > pos - window
    s_ = torch.where(valid[None, None, None, :], s_, NEG_INF)
    # the reference's softmax, exp(s - max) / sum, with the reductions over
    # the slots of every rank
    e = torch.exp(s_ - seq_max(s_.amax(dim=-1, keepdim=True)))
    p = e / seq_sum(e.sum(dim=-1, keepdim=True))
    out = seq_sum(torch.einsum("bkgs,bskh->bkgh",
                               p.to(cache_v.dtype).float(), cache_v.float()))
    return out.reshape(b, 1, h, hd).to(q.dtype)
