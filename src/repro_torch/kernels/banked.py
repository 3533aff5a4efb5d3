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
             (``csrc/tcam_match.cu``, ``dt2cam_tcam_match_banked``): one
             launch for the whole group.  Replaces the Pallas launch
             ``jax.vmap(tcam_match_pallas)`` of ``repro/kernels/banked.py``.
  'banked' — the division carry in PyTorch ops on the operands' device, the
             counterpart of the JAX package's batched XLA einsum.
  'ref'    — a loop over banks with the single-bank oracle.

``tcam_match_banked_cuda`` launches the kernel for CUDA tensors and runs the
plain version ``tcam_match_banked_plain`` for CPU tensors; any other device
raises.  ``tcam_match_banked_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.lut import bitplanes
from ..device import DeviceLike, resolve_device
from ._cuda import check_banked_args, launch_banked
from .ops import ArrayLike, _on
from .ref import tcam_match_banked_ref, tcam_match_ref

__all__ = ["BANKED_ENGINES", "BankedOperands", "prepare_banked", "run_banked",
           "tcam_match_banked", "tcam_match_banked_cuda",
           "tcam_match_banked_plain", "tcam_match_banked_ref"]

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
    return launch_banked(xbits, is0, is1, kmax, s)


tcam_match_banked_cuda.launches = 0


@dataclasses.dataclass(frozen=True)
class BankedOperands:
    """A group's device-resident operands: uint8 bitplanes (G, R, W) and
    kmax (G, R, D) int32, moved to the device once and reused by every
    batch (the JAX package folds them into jit constants)."""

    engine: str
    s: int
    is0: torch.Tensor
    is1: torch.Tensor
    kmax: torch.Tensor


def prepare_banked(
    cells: np.ndarray,                  # (G, R, W) int8 stacked cell grids
    s: int,
    kmax: Optional[ArrayLike] = None,   # (G, R, D) int32, default zeros
    *,
    engine: str = "banked",
    device: DeviceLike = None,
) -> BankedOperands:
    """Check the engine and move a group's bitplanes and kmax to the device."""
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
    is0, is1 = bitplanes(cells)
    return BankedOperands(engine=engine, s=s, is0=_on(is0, torch.uint8, dev),
                          is1=_on(is1, torch.uint8, dev), kmax=km)


def run_banked(ops: BankedOperands, xpad: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, B, W) uint8 padded search words on the operands' device ->
    (survive, evals), both (G, B, R) int32."""
    if ops.engine == "mxu":
        return tcam_match_banked_cuda(xpad, ops.is0, ops.is1, ops.kmax,
                                      s=ops.s)
    if ops.engine == "banked":
        return tcam_match_banked_ref(xpad, ops.is0, ops.is1, ops.s, ops.kmax)
    outs = [tcam_match_ref(xpad[i], ops.is0[i], ops.is1[i], ops.s, ops.kmax[i])
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
    return run_banked(ops, _on(xpad, torch.uint8, ops.is0.device))
