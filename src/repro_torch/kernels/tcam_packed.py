"""Bit-packed TCAM match (engine ``"packed"``): the CUDA kernel's wrapper.

The kernel (``csrc/tcam_packed.cu``) replaces the Pallas TPU kernel
``repro/kernels/tcam_packed.py`` (``_kernel`` /
``tcam_match_packed_pallas``).  32 cells share one word per plane
(``val = pack(is1)``, ``care = pack(is0 | is1)``) and a division's mismatch
count is ``Σ popc((x ^ val) & care)``.  Each thread walks the divisions of
one row and stops a (word, row) pair at its first mismatching division; the
source's header says why.  It needs S % 32 == 0 and no ``CELL_MM`` cells
(``ops.select_engine`` enforces both).

Words are int32 bit patterns (bit i of word j = column 32*j + i); the kernel
reads them as uint32.  ``tcam_match_packed_cuda`` launches the kernel for
CUDA tensors and runs the plain version ``tcam_match_packed_plain``
(``ref.tcam_match_packed_ref``) for CPU tensors; any other device raises.
``tcam_match_packed_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from ._cuda import check_match_args, launch_match
from .ref import tcam_match_packed_ref as tcam_match_packed_plain

__all__ = ["tcam_match_packed_cuda", "tcam_match_packed_plain"]


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
    if s % 32:
        raise ValueError(f"packed match needs S % 32 == 0, got S={s}")
    dev = check_match_args(xpacked, val, care, kmax, dtype=torch.int32,
                           names=("xpacked", "val", "care"),
                           words_per_division=s // 32)
    if dev.type == "cpu":
        return tcam_match_packed_plain(xpacked, val, care, s, kmax)
    if dev.type != "cuda":
        raise ValueError(f"tcam_match_packed_cuda: unsupported device {dev}")
    if xpacked.shape[1] * 4 > 48 * 1024:
        raise ValueError(
            f"{xpacked.shape[1]} words per search word exceed the kernel's "
            "48 KB shared-memory tile"
        )
    tcam_match_packed_cuda.launches += 1
    return launch_match("dt2cam_tcam_packed", "tcam_packed", xpacked, val,
                        care, kmax, xpacked.shape[1], s // 32)


tcam_match_packed_cuda.launches = 0
