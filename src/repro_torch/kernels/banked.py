"""Banked (multi-array) TCAM match: a forest's execution group at once.

A compiled forest is a set of banks, each an independent tiled TCAM with its
own search-word encoding.  Banks of one execution group share a padded shape
(R rows, W = D·S columns, from ``forest.plan``), so the group evaluates as
one invocation over a leading bank axis, with the selective-precharge carry
of ``ref.py`` per bank.  Stacking pad rows carry ``kmax = -1`` (they die in
division 0 with evals 1) and pad divisions are all-CELL_X (they match); the
caller slices the pad rows off and clamps evals with ``min(evals, d_real)``.

Engines (the JAX package's names, so a request means the same in both):
  'mxu'    — the bitplane CUDA kernel with a bank grid axis
             (``csrc/tcam_match.cu``, ``dt2cam_tcam_match_bits``, bank =
             ``blockIdx.z``): one pack and one match launch for the whole
             group, on planes packed once per group (``prepare_banked``).
             Replaces the Pallas launch ``jax.vmap(tcam_match_pallas)`` of
             ``repro/kernels/banked.py``.
  'banked' — the division carry in PyTorch ops on the operands' device, the
             counterpart of the JAX package's batched XLA einsum.
  'ref'    — a loop over banks with the single-bank oracle.

``tcam_match_banked_cuda`` (uint8 planes, packed per call) and
``tcam_match_banked_bits_cuda`` (planes packed once, the main path) launch
the kernel for CUDA tensors and run a plain version for CPU tensors
(``tcam_match_banked_plain``, and ``ref.tcam_match_bits_ref`` on the packed
operands); any other device raises.  Each one's ``.launches`` counts its
match launches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.lut import bitplanes
from ..device import DeviceLike, resolve_device
from ._cuda import check_banked_args, check_bits_args
from .ops import ArrayLike, _on
from .ref import tcam_match_banked_ref, tcam_match_ref
from .tcam_match import match_bits, pack_planes_cuda

__all__ = ["BANKED_ENGINES", "BankedOperands", "prepare_banked", "run_banked",
           "tcam_match_banked", "tcam_match_banked_bits_cuda",
           "tcam_match_banked_cuda", "tcam_match_banked_plain",
           "tcam_match_banked_ref"]

BANKED_ENGINES = ("banked", "mxu", "ref")

tcam_match_banked_plain = tcam_match_banked_ref


def tcam_match_banked_cuda(
    xbits: torch.Tensor,   # (G, B, W) uint8 {0,1}
    is0: torch.Tensor,     # (G, R, W) uint8 {0,1}
    is1: torch.Tensor,     # (G, R, W) uint8 {0,1}
    kmax: torch.Tensor,    # (G, R, W // s) int32
    *,
    s: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (survive, evals), both (G, B, R) int32, evals unclamped.
    Any B and R: the kernel masks the ragged edges."""
    dev = check_banked_args(xbits, is0, is1, kmax, s)
    if dev.type == "cpu":
        return tcam_match_banked_plain(xbits, is0, is1, s, kmax)
    if dev.type != "cuda":
        raise ValueError(f"tcam_match_banked_cuda: unsupported device {dev}")
    tcam_match_banked_cuda.launches += 1
    planes = pack_planes_cuda(is0, is1, s=s)
    return match_bits(xbits, planes, kmax.transpose(1, 2).contiguous(), s)


def tcam_match_banked_bits_cuda(
    xbits: torch.Tensor,    # (G, B, W) uint8 {0,1}
    planes: torch.Tensor,   # (G, D, R, 2·SW) int32, ref.pack_planes
    kmax_t: torch.Tensor,   # (G, D, R) int32
    *,
    s: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The main path's entry: a group's operands packed once.  Returns
    (survive, evals), both (G, B, R) int32, evals unclamped."""
    dev = check_bits_args(xbits, planes, kmax_t, s)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tcam_match_banked_bits_cuda: unsupported device "
                         f"{dev}")
    if dev.type == "cuda":
        tcam_match_banked_bits_cuda.launches += 1
    return match_bits(xbits, planes, kmax_t, s)


tcam_match_banked_cuda.launches = 0
tcam_match_banked_bits_cuda.launches = 0


@dataclasses.dataclass(frozen=True)
class BankedOperands:
    """A group's device-resident operands, moved to the device once and
    reused by every batch (the JAX package folds them into jit constants):
    for 'mxu' the packed planes ``a`` (G, D, R, 2·SW) int32 with ``b``
    None and ``kmax`` transposed to (G, D, R); for 'banked' and 'ref' the
    uint8 planes ``a = is0``, ``b = is1`` (G, R, W) and ``kmax``
    (G, R, D) int32."""

    engine: str
    s: int
    a: torch.Tensor
    b: Optional[torch.Tensor]
    kmax: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.kmax.device


def prepare_banked(
    cells: np.ndarray,                  # (G, R, W) int8 stacked cell grids
    s: int,
    kmax: Optional[ArrayLike] = None,   # (G, R, D) int32, default zeros
    *,
    engine: str = "banked",
    device: DeviceLike = None,
) -> BankedOperands:
    """Check the engine and move a group's operands to the device; for
    'mxu' pack the planes there (``pack_planes_cuda``) and transpose kmax."""
    if engine not in BANKED_ENGINES:
        raise ValueError(
            f"unknown banked engine {engine!r}; expected one of {BANKED_ENGINES}"
        )
    dev = resolve_device(device)
    cells = np.asarray(cells)
    g, r, w = cells.shape
    if w % s:
        raise ValueError(f"group width {w} is not a multiple of S={s}")
    km = (torch.zeros((g, r, w // s), dtype=torch.int32, device=dev)
          if kmax is None else _on(kmax, torch.int32, dev))
    is0, is1 = (_on(p, torch.uint8, dev) for p in bitplanes(cells))
    if engine == "mxu":
        return BankedOperands(engine=engine, s=s,
                              a=pack_planes_cuda(is0, is1, s=s), b=None,
                              kmax=km.transpose(1, 2).contiguous())
    return BankedOperands(engine=engine, s=s, a=is0, b=is1, kmax=km)


def run_banked(ops: BankedOperands, xpad: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, B, W) uint8 padded search words on the operands' device ->
    (survive, evals), both (G, B, R) int32."""
    if ops.engine == "mxu":
        return tcam_match_banked_bits_cuda(xpad, ops.a, ops.kmax, s=ops.s)
    if ops.engine == "banked":
        return tcam_match_banked_ref(xpad, ops.a, ops.b, ops.s, ops.kmax)
    outs = [tcam_match_ref(xpad[i], ops.a[i], ops.b[i], ops.s, ops.kmax[i])
            for i in range(xpad.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def tcam_match_banked(
    cells: np.ndarray,                  # (G, R, W) int8 stacked cell grids
    xpad: ArrayLike,                    # (G, B, W) per-bank padded words
    s: int,
    kmax: Optional[ArrayLike] = None,   # (G, R, D) int32
    *,
    engine: str = "banked",
    device: DeviceLike = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match a group of same-shape banks in one invocation; returns
    (survive, evals), both (G, B, R) int32 on ``device``, unclamped
    (see the module docstring for the padding conventions)."""
    ops = prepare_banked(cells, s, kmax, engine=engine, device=device)
    return run_banked(ops, _on(xpad, torch.uint8, ops.device))
