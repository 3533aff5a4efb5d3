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

Every version walks the divisions in order and carries the (B, R)
``active`` state (``(G, B, R)`` for the banked one), so none holds a
(B, R, D) array: at the Give Me Some Credit layout that would be about
16 GB, and at the credit forest's first group, 63 GB.

Packed words are int32 bit patterns (PyTorch has no unsigned shifts on the
CPU): bit ``i`` of word ``j`` is column ``32*j + i``.

The bitplane kernel's operands are packed per division and division-major
(``pack_words``, ``pack_planes``): each division's S cells fill SW =
ceil(S/32) words, zero-padded; ``tcam_match_bits_ref`` is its arithmetic,
``Σ popc((x & P0) | (~x & P1))`` per division.  The packed kernel's
operands are the same format (S % 32 == 0, so nothing is padded) with
``val = pack(is1)`` and ``care = pack(is0 | is1)`` in place of the two
planes; ``tcam_match_packed_bits_ref`` is its arithmetic,
``Σ popc((x ^ val) & care)``, and ``packed_division_major`` rearranges the
row-major packed words into that format.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["tcam_match_ref", "tcam_match_banked_ref", "tcam_match_packed_ref",
           "tcam_match_bits_ref", "tcam_match_packed_bits_ref",
           "packed_division_major", "pack_bits", "pack_divisions",
           "pack_planes", "pack_words", "popcount32", "words_per_division"]


def _carry(mism_of, shape: tuple, d: int, limit_of,
           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective-precharge carry over divisions; ``mism_of(j)`` gives the
    mismatch counts of division j and ``limit_of(j)`` its tolerance, both
    broadcastable to ``shape``."""
    active = torch.ones(shape, dtype=torch.int32, device=device)
    evals = torch.zeros(shape, dtype=torch.int32, device=device)
    for j in range(d):
        evals += active
        active *= (mism_of(j) <= limit_of(j)).to(torch.int32)
    return active, evals


def _limit_2d(kmax: Optional[torch.Tensor]):
    """Division j's tolerance of an (R, D) kmax as a (1, R) row."""
    if kmax is None:
        return lambda j: 0
    return lambda j: kmax[:, j].to(torch.int32)[None, :]


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

    return _carry(mism, (b, r), w // s, _limit_2d(kmax), xbits.device)


def tcam_match_banked_ref(
    xbits: torch.Tensor,   # (G, B, W) {0,1}: each bank's own search words
    is0: torch.Tensor,     # (G, R, W)
    is1: torch.Tensor,     # (G, R, W)
    s: int,
    kmax: Optional[torch.Tensor] = None,   # (G, R, D) int32, default zeros
) -> tuple[torch.Tensor, torch.Tensor]:
    """Banked bitplane oracle: G same-shape banks at once, (survive, evals)
    both (G, B, R) int32.  Per division two batched float32 products (exact:
    counts <= S < 2^24) and the same (G, B, R) carry as the single bank; with
    one division every row is evaluated once (evals all 1)."""
    g, b, w = xbits.shape
    r = is0.shape[1]
    if w % s:
        raise ValueError(f"width {w} is not a multiple of S={s}")
    x = xbits.to(torch.float32)
    p0 = is0.to(torch.float32)
    p1 = is1.to(torch.float32)

    def mism(j: int) -> torch.Tensor:
        cols = slice(j * s, (j + 1) * s)
        xd = x[:, :, cols]
        m = torch.bmm(xd, p0[:, :, cols].transpose(1, 2))
        return m.baddbmm_(1.0 - xd, p1[:, :, cols].transpose(1, 2))

    def limit(j: int):
        return 0 if kmax is None else kmax[:, None, :, j].to(torch.int32)

    return _carry(mism, (g, b, r), w // s, limit, xbits.device)


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

    return _carry(mism, (b, r), w32 // sw, _limit_2d(kmax),
                  xpacked.device)


def words_per_division(s: int) -> int:
    """SW: the 32-bit words that hold one division of S cells."""
    return -(-s // 32)


def pack_divisions(bits: torch.Tensor, s: int) -> torch.Tensor:
    """(..., W) {0,1} -> (..., W // s, SW) int32: each division of S cells
    packed as ``pack_bits`` packs, zero-padded to SW·32 bits.  Where
    S % 32 == 0 this is ``pack_bits(bits)`` with its last axis split."""
    *lead, w = bits.shape
    if w % s:
        raise ValueError(f"width {w} is not a multiple of S={s}")
    divs = bits.reshape(*lead, w // s, s)
    pad = 32 * words_per_division(s) - s
    if pad:
        divs = torch.nn.functional.pad(divs, (0, pad))
    return pack_bits(divs)


def pack_words(xbits: torch.Tensor, s: int) -> torch.Tensor:
    """Search words (..., B, W) {0,1} -> (..., D, Bp, SW) int32, division-
    major, with B rounded up to Bp, a multiple of 4, by zero words (the
    kernel stages each division's words in 16-byte copies)."""
    b = xbits.shape[-2]
    words = pack_divisions(xbits, s).transpose(-3, -2)
    return torch.nn.functional.pad(words, (0, 0, 0, -b % 4)).contiguous()


def pack_planes(is0: torch.Tensor, is1: torch.Tensor, s: int) -> torch.Tensor:
    """Bitplanes (..., R, W) {0,1} -> (..., D, R, 2·SW) int32, division-
    major: for each (division, row) is0's SW words, then is1's."""
    both = torch.cat((pack_divisions(is0, s), pack_divisions(is1, s)), dim=-1)
    return both.transpose(-3, -2).contiguous()


def tcam_match_bits_ref(
    xw: torch.Tensor,       # (..., D, Bp, SW) int32, from pack_words
    planes: torch.Tensor,   # (..., D, R, 2·SW) int32, from pack_planes
    kmax_t: torch.Tensor,   # (..., D, R) int32, kmax transposed
    b: int,                 # search words (the first b of Bp)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bitplane kernel's arithmetic on its packed operands: a division's
    mismatch count is ``Σ popc((x & P0) | (~x & P1))`` over its SW words
    (a CELL_MM cell sets both bits and mismatches either input), then the
    same carry as ``tcam_match_ref``.  Returns (survive, evals), both
    (..., b, R) int32."""
    sw = xw.shape[-1]
    d, r = planes.shape[-3], planes.shape[-2]
    if planes.shape[-1] != 2 * sw or xw.shape[-3] != d:
        raise ValueError(f"packed shapes disagree: words {tuple(xw.shape)}, "
                         f"planes {tuple(planes.shape)}")
    x = xw[..., :b, :]

    def mism(j: int) -> torch.Tensor:
        xd = x[..., j, :, None, :]                  # (..., b, 1, SW)
        pd = planes[..., j, None, :, :]             # (..., 1, R, 2·SW)
        cells = (xd & pd[..., :sw]) | (~xd & pd[..., sw:])
        return popcount32(cells).sum(dim=-1, dtype=torch.int32)

    return _carry(mism, (*xw.shape[:-3], b, r), d,
                  lambda j: kmax_t[..., j, None, :], xw.device)


def tcam_match_packed_bits_ref(
    xw: torch.Tensor,       # (D, Bp, SW) int32, from pack_words
    vc: torch.Tensor,       # (D, R, 2·SW) int32: val's words, then care's
    kmax_t: torch.Tensor,   # (D, R) int32, kmax transposed
    b: int,                 # search words (the first b of Bp)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed kernel's arithmetic on its division-major operands: a
    division's mismatch count is ``Σ popc((x ^ val) & care)`` over its SW
    words, then the same carry as ``tcam_match_packed_ref``.  Returns
    (survive, evals), both (b, R) int32."""
    sw = xw.shape[-1]
    d, r = vc.shape[0], vc.shape[1]
    if vc.shape[-1] != 2 * sw or xw.shape[0] != d:
        raise ValueError(f"packed shapes disagree: words {tuple(xw.shape)}, "
                         f"vc {tuple(vc.shape)}")
    x = xw[:, :b]

    def mism(j: int) -> torch.Tensor:
        m = torch.zeros((b, r), dtype=torch.int32, device=xw.device)
        for k in range(sw):
            val, care = vc[j, None, :, k], vc[j, None, :, sw + k]
            m += popcount32((x[j, :, k, None] ^ val) & care)
        return m

    return _carry(mism, (b, r), d, lambda j: kmax_t[j, None, :], xw.device)


def packed_division_major(
    xpacked: torch.Tensor,   # (B, W32) int32
    val: torch.Tensor,       # (R, W32) int32
    care: torch.Tensor,      # (R, W32) int32
    kmax: torch.Tensor,      # (R, D) int32
    s: int,                  # division width in bits (multiple of 32)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-major packed operands (``tcam_match_packed_ref``'s) -> the packed
    kernel's: xw (D, Bp, SW) as ``pack_words`` lays them out, vc (D, R,
    2·SW) and kmax_t (D, R), on the operands' device."""
    b, w32 = xpacked.shape
    r = val.shape[0]
    sw = s // 32
    d = w32 // sw
    xw = torch.nn.functional.pad(xpacked.reshape(b, d, sw).transpose(0, 1),
                                 (0, 0, 0, -b % 4))
    vc = torch.cat((val.reshape(r, d, sw), care.reshape(r, d, sw)), dim=-1)
    return (xw.contiguous(), vc.transpose(0, 1).contiguous(),
            kmax.t().contiguous())
