"""Bitplane TCAM match (engine ``"mxu"``): the CUDA kernel's wrapper.

The kernel (``csrc/tcam_match.cu``) replaces the Pallas TPU kernel
``repro/kernels/tcam_match.py`` (``_kernel`` / ``tcam_match_pallas``).  It
takes uint8 {0,1} planes and search words, walks the column divisions inside
each thread and stops a (word, row) pair at its first mismatching division;
the source's header says why.  It handles every cell state, including the
SAF-induced ``CELL_MM`` (both planes set).

``tcam_match_cuda`` launches the kernel for CUDA tensors and runs the plain
version ``tcam_match_plain`` (``ref.tcam_match_ref``) for CPU tensors; any
other device raises.  ``tcam_match_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from ._cuda import check_match_args, launch_match
from .ref import tcam_match_ref as tcam_match_plain

__all__ = ["tcam_match_cuda", "tcam_match_plain"]


def tcam_match_cuda(
    xbits: torch.Tensor,   # (B, W) uint8 {0,1}
    is0: torch.Tensor,     # (R, W) uint8 {0,1}
    is1: torch.Tensor,     # (R, W) uint8 {0,1}
    kmax: torch.Tensor,    # (R, W // s) int32
    *,
    s: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (survive, evals), both (B, R) int32 (semantics in ``ref``).
    Any B and R: the kernel masks the ragged edges."""
    dev = check_match_args(xbits, is0, is1, kmax, dtype=torch.uint8,
                           names=("xbits", "is0", "is1"), words_per_division=s)
    if dev.type == "cpu":
        return tcam_match_plain(xbits, is0, is1, s, kmax)
    if dev.type != "cuda":
        raise ValueError(f"tcam_match_cuda: unsupported device {dev}")
    tcam_match_cuda.launches += 1
    return launch_match("dt2cam_tcam_match", "tcam_match", xbits, is0, is1,
                        kmax, xbits.shape[1], s)


tcam_match_cuda.launches = 0
