"""Bitplane TCAM match (engine ``"mxu"``): the CUDA kernel's wrappers.

The kernel (``csrc/tcam_match.cu``) replaces the Pallas TPU kernel
``repro/kernels/tcam_match.py`` (``_kernel`` / ``tcam_match_pallas``) and
its vmapped launch over a forest group's banks.  It handles every cell
state, including the SAF-induced ``CELL_MM`` (both planes set).  It runs on
bit-packed, division-major operands (the source's header says why):

  planes (G, D, R, 2·SW) int32 — ``ref.pack_planes``: per (division, row)
          is0's SW = ceil(S/32) words, then is1's;
  kmax_t (G, D, R) int32 — kmax transposed;
  xw     (G, D, Bp, SW) int32 — ``ref.pack_words``, packed on the card per
          call from the uint8 search words.

Two entry points for one bank (``tcam_match_banked_cuda`` and
``tcam_match_banked_bits_cuda`` in ``banked.py`` take G banks):

  ``tcam_match_cuda(xbits, is0, is1, kmax, s=)`` — uint8 planes, packed
      per call: the form the tests and the kernel checks use;
  ``tcam_match_bits_cuda(xbits, planes, kmax_t, s=)`` — operands packed
      once per layout (``ops.prepare_match``): the main path.

Each launches the pack and match kernels for CUDA tensors and runs a plain
version for CPU tensors (``tcam_match_plain`` = ``ref.tcam_match_ref``, and
``ref.tcam_match_bits_ref`` on the packed operands); any other device
raises, as does a failed build or launch.  Each entry point's
``.launches`` counts its match launches; ``pack_words_cuda.launches`` and
``pack_planes_cuda.launches`` count the pack kernel's, and
``_cuda.MATCH_PATH_LAUNCHES`` every match launch by path.
"""
from __future__ import annotations

import torch

from ._cuda import (check_bits_args, check_match_args, launch_match_bits,
                    launch_pack)
from .ref import pack_planes, pack_words, tcam_match_bits_ref
from .ref import tcam_match_ref as tcam_match_plain

__all__ = ["pack_planes_cuda", "pack_words_cuda", "tcam_match_bits_cuda",
           "tcam_match_cuda", "tcam_match_plain"]


def _device_kind(dev: torch.device, who: str) -> str:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {dev}")
    return dev.type


def pack_words_cuda(xbits: torch.Tensor, *, s: int) -> torch.Tensor:
    """Search words (G, B, W) uint8 {0,1} -> (G, D, Bp, SW) int32
    (``ref.pack_words``), on the card by the pack kernel."""
    if _device_kind(xbits.device, "pack_words_cuda") == "cpu":
        return pack_words(xbits, s)
    pack_words_cuda.launches += 1
    b = xbits.shape[1]
    return launch_pack(xbits.contiguous(), None, s, b + (-b % 4))


def pack_planes_cuda(is0: torch.Tensor, is1: torch.Tensor, *,
                     s: int) -> torch.Tensor:
    """Planes (G, R, W) uint8 {0,1} -> (G, D, R, 2·SW) int32
    (``ref.pack_planes``), on the card by the pack kernel."""
    if is1.shape != is0.shape or is1.device != is0.device:
        raise ValueError(f"planes disagree: is0 {tuple(is0.shape)} on "
                         f"{is0.device}, is1 {tuple(is1.shape)} on {is1.device}")
    if _device_kind(is0.device, "pack_planes_cuda") == "cpu":
        return pack_planes(is0, is1, s)
    pack_planes_cuda.launches += 1
    return launch_pack(is0.contiguous(), is1.contiguous(), s, is0.shape[1])


def match_bits(xbits: torch.Tensor, planes: torch.Tensor,
               kmax_t: torch.Tensor, s: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, B, W) uint8 words against packed operands -> (G, B, R) int32
    (survive, evals): the pack and match kernels on the card, the plain
    versions on the CPU.  The caller has checked the arguments."""
    xw = pack_words_cuda(xbits, s=s)
    if xbits.device.type == "cpu":
        return tcam_match_bits_ref(xw, planes, kmax_t, xbits.shape[1])
    return launch_match_bits(xw, planes, kmax_t, xbits.shape[1], s)


def tcam_match_bits_cuda(
    xbits: torch.Tensor,    # (B, W) uint8 {0,1}
    planes: torch.Tensor,   # (D, R, 2·SW) int32, ref.pack_planes
    kmax_t: torch.Tensor,   # (D, R) int32
    *,
    s: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The main path's entry: operands packed once per layout.  Returns
    (survive, evals), both (B, R) int32."""
    _device_kind(xbits.device, "tcam_match_bits_cuda")
    check_bits_args(xbits[None], planes[None], kmax_t[None], s)
    if xbits.device.type == "cuda":
        tcam_match_bits_cuda.launches += 1
    survive, evals = match_bits(xbits[None], planes[None], kmax_t[None], s)
    return survive[0], evals[0]


def tcam_match_cuda(
    xbits: torch.Tensor,   # (B, W) uint8 {0,1}
    is0: torch.Tensor,     # (R, W) uint8 {0,1}
    is1: torch.Tensor,     # (R, W) uint8 {0,1}
    kmax: torch.Tensor,    # (R, W // s) int32
    *,
    s: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (survive, evals), both (B, R) int32 (semantics in ``ref``).
    Any B and R: the kernel masks the ragged edges.  On the card the planes
    are packed per call."""
    dev = check_match_args(xbits, is0, is1, kmax, dtype=torch.uint8,
                           names=("xbits", "is0", "is1"), words_per_division=s)
    if _device_kind(dev, "tcam_match_cuda") == "cpu":
        return tcam_match_plain(xbits, is0, is1, s, kmax)
    tcam_match_cuda.launches += 1
    planes = pack_planes_cuda(is0[None], is1[None], s=s)
    kmax_t = kmax.t().contiguous()[None]
    survive, evals = match_bits(xbits[None], planes, kmax_t, s)
    return survive[0], evals[0]


tcam_match_cuda.launches = 0
tcam_match_bits_cuda.launches = 0
pack_words_cuda.launches = 0
pack_planes_cuda.launches = 0
