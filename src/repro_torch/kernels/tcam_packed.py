"""Bit-packed TCAM match (engine ``"packed"``): the CUDA kernel's wrappers.

The kernel (``csrc/tcam_packed.cu``) replaces the Pallas TPU kernel
``repro/kernels/tcam_packed.py`` (``_kernel`` /
``tcam_match_packed_pallas``).  32 cells share one word per operand
(``val = pack(is1)``, ``care = pack(is0 | is1)``) and a division's mismatch
count is ``Σ popc((x ^ val) & care)``.  It needs S % 32 == 0 and no
``CELL_MM`` cells (``ops.select_engine`` enforces both).  It runs on
division-major operands (the source's header says why):

  vc     (D, R, 2·SW) int32 — per (division, row) val's SW = S/32 words,
         then care's: ``pack_planes_cuda(is1, is0 | is1)``, once per layout;
  kmax_t (D, R) int32 — kmax transposed;
  xw     (D, Bp, SW) int32 — ``ref.pack_words``, packed on the card per call
         from the uint8 search words by the bitplane kernel's pack kernel.

Two entry points:

  ``tcam_match_packed_bits_cuda(xbits, vc, kmax_t, s=)`` — operands packed
      once per layout (``ops.prepare_match``): the main path;
  ``tcam_match_packed_cuda(xpacked, val, care, kmax, s=)`` — row-major
      packed words as the JAX package holds them, rearranged on the card
      into the division-major format (``ref.packed_division_major``).

Each launches the kernel for CUDA tensors and runs a plain version for CPU
tensors (``ref.tcam_match_packed_bits_ref`` after ``ref.pack_words``, and
``tcam_match_packed_plain`` = ``ref.tcam_match_packed_ref``); any other
device raises, as does a failed build or launch.  Words are int32 bit
patterns (bit i of word j = cell 32*j + i of the division); the kernel
reads them as uint32.  Each entry point's ``.launches`` counts its kernel
launches, and ``_cuda.PACKED_PATH_LAUNCHES`` every launch by path.
"""
from __future__ import annotations

import torch

from ._cuda import check_bits_args, check_match_args, launch_packed_bits
from .ref import packed_division_major, tcam_match_packed_bits_ref
from .ref import tcam_match_packed_ref as tcam_match_packed_plain
from .tcam_match import _device_kind, pack_words_cuda

__all__ = ["tcam_match_packed_bits_cuda", "tcam_match_packed_cuda",
           "tcam_match_packed_plain"]


def _check_width(s: int) -> None:
    if s % 32:
        raise ValueError(f"packed match needs S % 32 == 0, got S={s}")


def tcam_match_packed_bits_cuda(
    xbits: torch.Tensor,    # (B, W) uint8 {0,1}
    vc: torch.Tensor,       # (D, R, 2·SW) int32
    kmax_t: torch.Tensor,   # (D, R) int32
    *,
    s: int,                 # division width in bits (multiple of 32)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The main path's entry: the search words packed on the card, then the
    match.  Returns (survive, evals), both (B, R) int32."""
    _check_width(s)
    kind = _device_kind(xbits.device, "tcam_match_packed_bits_cuda")
    check_bits_args(xbits[None], vc[None], kmax_t[None], s, name="vc")
    xw = pack_words_cuda(xbits[None], s=s)[0]
    if kind == "cpu":
        return tcam_match_packed_bits_ref(xw, vc, kmax_t, xbits.shape[0])
    tcam_match_packed_bits_cuda.launches += 1
    return launch_packed_bits(xw, vc, kmax_t, xbits.shape[0], s)


def tcam_match_packed_cuda(
    xpacked: torch.Tensor,   # (B, W32) int32 bit patterns
    val: torch.Tensor,       # (R, W32) int32
    care: torch.Tensor,      # (R, W32) int32
    kmax: torch.Tensor,      # (R, W32 // (s // 32)) int32
    *,
    s: int,                  # division width in bits (multiple of 32)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (survive, evals), both (B, R) int32 (semantics in ``ref``).
    Any B and R: the kernel masks the ragged edges."""
    _check_width(s)
    dev = check_match_args(xpacked, val, care, kmax, dtype=torch.int32,
                           names=("xpacked", "val", "care"),
                           words_per_division=s // 32)
    if _device_kind(dev, "tcam_match_packed_cuda") == "cpu":
        return tcam_match_packed_plain(xpacked, val, care, s, kmax)
    tcam_match_packed_cuda.launches += 1
    xw, vc, kmax_t = packed_division_major(xpacked, val, care, kmax, s)
    return launch_packed_bits(xw, vc, kmax_t, xpacked.shape[0], s)


tcam_match_packed_bits_cuda.launches = 0
tcam_match_packed_cuda.launches = 0
