"""ReCAM functional synthesizer — simulation step (paper §II.C.2).

Evaluates a synthesized TCAM layout functionally (match/mismatch per row per
column division, selective-precharge active-row propagation) and converts the
activity trace into energy / latency / throughput / accuracy numbers via the
analog model in ``energy.py``.

This module is the *numpy oracle*; the PyTorch / CUDA paths in
``repro_torch.kernels`` are validated against it bit-exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import numpy as np

from .energy import DEFAULT_HW, HardwareParams, f_max, t_cwd, t_opt
from .lut import bitplanes
from .synth import TCAMLayout

__all__ = ["SimResult", "mismatch_counts", "simulate", "sense_voltage"]


@dataclasses.dataclass
class SimResult:
    predictions: np.ndarray          # (batch,) int32 — argmax surviving row class
    survivors: np.ndarray            # (batch,) int32 — surviving row index (-1 none)
    n_survivors: np.ndarray          # (batch,) int32
    active_evals: np.ndarray         # (batch,) int64 — Σ active row-divisions (N_a)
    energy_per_dec: np.ndarray       # (batch,) J
    latency_s: float                 # sequential T_total per input
    throughput_seq: float            # dec/s, sequential column divisions
    throughput_pipe: float           # dec/s, pipelined column divisions
    s: int
    n_cwd: int
    n_rwd: int

    @property
    def mean_energy(self) -> float:
        return float(self.energy_per_dec.mean())

    @property
    def edp(self) -> float:
        """Energy-delay product per decision (J·s), sequential operation."""
        return self.mean_energy * self.latency_s

    def accuracy(self, labels: np.ndarray) -> float:
        return float((self.predictions == np.asarray(labels)).mean())

    # ``kernels.tcam_infer`` once returned a bare 5-tuple and SimResult kept
    # a one-release tuple-unpacking shim; the shim has expired.  Keeping the
    # method (raising) turns old unpacking call sites into an actionable
    # error instead of a generic "cannot unpack non-iterable" TypeError.
    def __iter__(self) -> "Iterator[np.ndarray]":
        raise TypeError(
            "tuple-unpacking a SimResult was removed; use the named fields "
            "(.predictions, .survivors, .n_survivors, .active_evals, "
            ".energy_per_dec) instead"
        )


def sense_voltage(
    k_mismatch: np.ndarray,
    n_eff: np.ndarray,
    s: int,
    hw: HardwareParams = DEFAULT_HW,
) -> np.ndarray:
    """Match-line voltage at the design sensing time T_opt(S) for rows with
    ``k_mismatch`` mismatching cells out of ``n_eff`` unmasked cells."""
    k = np.asarray(k_mismatch, dtype=np.float64)
    n = np.asarray(n_eff, dtype=np.float64)
    g_match = np.maximum(n - k, 0.0) / hw.r_cell_match
    g_mm = k / hw.r_cell_mismatch
    r_row = 1.0 / np.maximum(g_match + g_mm, 1e-12)
    return hw.v_dd * np.exp(-t_opt(s, hw) / (r_row * hw.c_in))


def mismatch_counts(cells: np.ndarray, xbits: np.ndarray) -> np.ndarray:
    """(batch, rows) mismatch counts — the bitplane formulation:
    mism = X·is0ᵀ + (1-X)·is1ᵀ  (CELL_MM sets both planes -> always +1).

    float32 BLAS matmul: exact because counts <= width < 2^24.
    """
    is0, is1 = bitplanes(cells)
    x = xbits.astype(np.float32)
    out = x @ is0.T.astype(np.float32) + (1.0 - x) @ is1.T.astype(np.float32)
    return np.rint(out).astype(np.int64)


def _division_mismatches(
    layout: TCAMLayout, xpad: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per column division d: (batch, rows, n_cwd) mismatch counts and
    (n_cwd,) effective (unmasked) cell count per row.

    Masked cells: padding columns beyond the decoder+LUT width in the *last*
    column division are masked (OFF-OFF) and contribute neither mismatches nor
    match-line conductance (paper §II.C.1 'Input Processing')."""
    s, n_cwd = layout.s, layout.n_cwd
    b = xpad.shape[0]
    rows = layout.cells.shape[0]
    counts = np.zeros((b, rows, n_cwd), dtype=np.int64)
    used = 1 + layout.width  # decoder column + encoded LUT bits
    n_eff = np.zeros(n_cwd, dtype=np.int64)
    for d in range(n_cwd):
        lo, hi = d * s, (d + 1) * s
        real = max(0, min(hi, used) - lo)  # unmasked columns in this division
        n_eff[d] = real
        if real == 0:
            continue
        counts[:, :, d] = mismatch_counts(
            layout.cells[:, lo : lo + real], xpad[:, lo : lo + real]
        )
    return counts, n_eff


def simulate(
    layout: TCAMLayout,
    xbits: np.ndarray,
    *,
    hw: HardwareParams = DEFAULT_HW,
    selective_precharge: bool = True,
    sa_sigma: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> SimResult:
    """Functionally evaluate encoded inputs against the tiled layout.

    sa_sigma > 0 enables the sense-amplifier manufacturing-variability model:
    each physical SA (one per row per column division) gets a fixed offset
    ~N(0, sa_sigma) on its reference voltage; a row's sensed match/mismatch is
    decided by comparing the analog match-line voltage (from the *exact*
    mismatch count) against V_ref + offset (paper §II.C.2).
    """
    xpad = layout.pad_inputs(np.asarray(xbits, dtype=np.uint8))
    counts, n_eff = _division_mismatches(layout, xpad)
    b, rows, n_cwd = counts.shape
    s = layout.s

    if sa_sigma > 0.0:
        rng = rng or np.random.default_rng(0)
        offsets = rng.normal(0.0, sa_sigma, size=(rows, n_cwd))
        v_ml = sense_voltage(counts, n_eff[None, None, :], s, hw)
        # V_ref per division: midpoint of (V_fm, V_1mm) for that division's
        # effective row size; the last division uses V_ref2 (masked cells).
        v_fm = sense_voltage(np.zeros(n_cwd), n_eff, s, hw)
        v_1mm = sense_voltage(np.ones(n_cwd), n_eff, s, hw)
        v_ref = 0.5 * (v_fm + v_1mm)
        match = v_ml > (v_ref[None, None, :] + offsets[None, :, :])
    else:
        match = counts == 0

    # Selective precharge: active[d] = matched all previous divisions.
    # active_in[:, :, d] == row evaluated (precharged + sensed) in division d.
    prior = np.cumprod(
        np.concatenate([np.ones((b, rows, 1), bool), match[:, :, :-1]], axis=2),
        axis=2,
    ).astype(bool)
    survive = prior[:, :, -1] & match[:, :, -1]

    if selective_precharge:
        active_evals = prior.sum(axis=(1, 2)).astype(np.int64)
    else:
        active_evals = np.full(b, rows * n_cwd, dtype=np.int64)

    n_survivors = survive.sum(axis=1).astype(np.int32)
    first = np.argmax(survive, axis=1).astype(np.int32)
    survivors = np.where(n_survivors > 0, first, -1).astype(np.int32)
    predictions = np.where(
        n_survivors > 0, layout.classes[np.maximum(survivors, 0)], 0
    ).astype(np.int32)

    energy = active_evals.astype(np.float64) * hw.e_row + hw.e_mem
    fm = f_max(s, hw)
    latency = n_cwd * t_cwd(s, hw) + hw.t_mem
    return SimResult(
        predictions=predictions,
        survivors=survivors,
        n_survivors=n_survivors,
        active_evals=active_evals,
        energy_per_dec=energy,
        latency_s=latency,
        throughput_seq=fm / n_cwd,
        throughput_pipe=fm / hw.pipeline_ii_cycles,
        s=s,
        n_cwd=n_cwd,
        n_rwd=layout.n_rwd,
    )
