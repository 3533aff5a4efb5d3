"""Plain PyTorch versions of the TCAM match: the oracles both CUDA kernels
are held against, and what their wrappers run for tensors on the CPU.

Semantics (shared by both kernels):

Given encoded search words ``x ∈ {0,1}^{B×W}`` (decoder bit included, padded
to W = n_cwd·S), bitplanes ``is0, is1 ∈ {0,1}^{R×W}`` (CELL_X sets neither,
CELL_MM sets both) and a per-(row, division) mismatch tolerance
``kmax ∈ ℤ^{R×D}`` (0 = ideal hardware; >0 models SA reference-voltage
offsets that would sense a near-match as a match; -1 never matches):

  for each column division d (width S, sequential — selective precharge):
    mism[b, r, d]  = Σ_{w∈d} x·is0 + (1-x)·is1
    match[b, r, d] = mism[b, r, d] <= kmax[r, d]
    a row is *active* in division d iff it matched all previous divisions;
    an *active evaluation* is (row, division) pair with the row active.

Returns:
  survive (B, R) int32 — 1 iff the row matched every division,
  evals   (B, R) int32 — number of divisions the row was evaluated in
                          (∈ [1, D]; this drives the energy model).

Both versions walk the divisions in order and carry the (B, R) ``active``
state, so they never hold a (B, R, D) array: at the Give Me Some Credit
layout that would be about 16 GB.

Packed words are int32 bit patterns (PyTorch has no unsigned shifts on the
CPU): bit ``i`` of word ``j`` is column ``32*j + i``.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["tcam_match_ref", "tcam_match_packed_ref", "pack_bits", "popcount32"]


def _carry(mism_of, b: int, r: int, d: int, kmax: Optional[torch.Tensor],
           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective-precharge carry over divisions; ``mism_of(j)`` gives the
    (B, R) mismatch counts of division j."""
    active = torch.ones((b, r), dtype=torch.int32, device=device)
    evals = torch.zeros((b, r), dtype=torch.int32, device=device)
    for j in range(d):
        evals += active
        limit = 0 if kmax is None else kmax[:, j].to(torch.int32)[None, :]
        active *= (mism_of(j) <= limit).to(torch.int32)
    return active, evals


def tcam_match_ref(
    xbits: torch.Tensor,   # (B, W) any int/float dtype with {0,1} values
    is0: torch.Tensor,     # (R, W)
    is1: torch.Tensor,     # (R, W)
    s: int,                # column-division width (tile edge S)
    kmax: Optional[torch.Tensor] = None,   # (R, D) int32, default ideal (zeros)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bitplane oracle: per division two float32 products, exact because the
    counts are at most S < 2^24."""
    b, w = xbits.shape
    r = is0.shape[0]
    if w % s:
        raise ValueError(f"width {w} is not a multiple of S={s}")
    x = xbits.to(torch.float32)
    p0 = is0.to(torch.float32)
    p1 = is1.to(torch.float32)

    def mism(j: int) -> torch.Tensor:
        cols = slice(j * s, (j + 1) * s)
        xd = x[:, cols]
        m = xd @ p0[:, cols].T + (1.0 - xd) @ p1[:, cols].T
        return m.to(torch.int32)

    return _carry(mism, b, r, w // s, kmax, xbits.device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., W) tensor of {0,1} into (..., W//32) int32 bit patterns,
    little-endian within each word (bit i of word j = column 32*j + i).
    W % 32 == 0.  Bit 31 lands in the sign bit; the sum cannot overflow
    because every word's bits are distinct powers of two."""
    *lead, w = bits.shape
    if w % 32:
        raise ValueError(f"width {w} is not a multiple of 32")
    b = bits.to(torch.int32).reshape(*lead, w // 32, 32)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return (b << shifts).sum(dim=-1, dtype=torch.int32)


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR).  Right shifts are arithmetic on
    int32, so every step masks away the copies of the sign bit."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def tcam_match_packed_ref(
    xpacked: torch.Tensor,   # (B, W32) int32 bit patterns
    val: torch.Tensor,       # (R, W32) int32 — packed is1 (stored bit values)
    care: torch.Tensor,      # (R, W32) int32 — packed (is0 | is1)
    s: int,                  # division width in BITS (multiple of 32)
    kmax: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-domain oracle.  A cell mismatches iff its care bit is set and
    the input bit differs from the value bit: popcount((x ^ val) & care).

    CELL_MM (both planes set) is *not representable* in packed form — the
    packed kernel is for defect-free LUTs (ideal or SA-variability studies);
    the bitplane kernel handles SAF-injected cells.
    """
    b, w32 = xpacked.shape
    r = val.shape[0]
    if s % 32:
        raise ValueError(f"packed match needs S % 32 == 0, got S={s}")
    sw = s // 32
    if w32 % sw:
        raise ValueError(f"{w32} words are not a multiple of S/32={sw}")

    def mism(j: int) -> torch.Tensor:
        m = torch.zeros((b, r), dtype=torch.int32, device=xpacked.device)
        for k in range(j * sw, (j + 1) * sw):
            diff = (xpacked[:, k, None] ^ val[None, :, k]) & care[None, :, k]
            m += popcount32(diff)
        return m

    return _carry(mism, b, r, w32 // sw, kmax, xpacked.device)
