"""Delta reprogramming planner: cell-wise layout diff -> minimal write plan.

ReCAM cells have finite write endurance (RETENTION: endurance-aware write
reduction is *the* lever for CAM-resident tree ensembles), so redeploying a
retrained tree must not rewrite the whole array.  This module plans the
programming pass at the resolution the hardware actually works at: the two
resistive elements of each 2T2R cell.

A cell state maps to an (R1, R2) LRS/HRS pair (``core.nonideal.CELL_TO_PAIR``);
a state transition costs one SET pulse (HRS -> LRS) or one RESET pulse
(LRS -> HRS) per element that changes:

    CELL_0 -> CELL_1   flips both elements   (1 SET + 1 RESET)
    CELL_0 -> CELL_X   releases R2           (1 RESET)
    CELL_X -> CELL_1   programs R1           (1 SET)
    ...

``plan_delta`` touches only the cells whose state differs between the live
and the candidate layout (plus changed 1T1R class bits); ``plan_full`` models
the naive erase-then-program pass that rewrites every address.  Both return a
``WritePlan`` whose pulse maps feed the endurance tracker
(``lifecycle.wear.WearTracker``) and whose totals feed the write-energy model
(``core.energy.reprogram_figures``).

Layout grids of different physical shape are aligned by padding with CELL_X
(an unprogrammed cell — both elements HRS), modelling one physical array
large enough for both layouts.  ``plan_forest_delta`` diffs a multi-bank
forest bank-by-bank; a bank added by the candidate is programmed from an
erased array, a retired bank is erased.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.energy import DEFAULT_HW, HardwareParams, reprogram_figures
from ..core.lut import CELL_0, CELL_1, CELL_MM, CELL_X

__all__ = ["WritePlan", "cell_planes", "plan_delta", "plan_full",
           "plan_forest_delta"]


def cell_planes(cells: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(r1_lrs, r2_lrs) boolean element planes of a cell-state grid
    (Table I encoding: CELL_0={HRS,LRS}, CELL_1={LRS,HRS}, CELL_X={HRS,HRS},
    CELL_MM={LRS,LRS})."""
    cells = np.asarray(cells)
    r1 = (cells == CELL_1) | (cells == CELL_MM)
    r2 = (cells == CELL_0) | (cells == CELL_MM)
    return r1, r2


def _pad_grid(cells: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Pad a cell grid with CELL_X (erased) up to ``shape``."""
    cells = np.asarray(cells)
    if cells.shape == shape:
        return cells
    out = np.full(shape, CELL_X, dtype=np.int8)
    out[: cells.shape[0], : cells.shape[1]] = cells
    return out


def _pad_bits(bits: Optional[np.ndarray],
              shape: tuple[int, int]) -> np.ndarray:
    """Pad a class-bit grid with 0 (erased 1T1R) up to ``shape``."""
    out = np.zeros(shape, dtype=np.uint8)
    if bits is not None:
        b = np.asarray(bits)
        out[: b.shape[0], : b.shape[1]] = b
    return out


@dataclasses.dataclass
class WritePlan:
    """One programming pass over a TCAM bank, at write-pulse resolution.

    set_map / reset_map: (rows, cols) int16 — per-cell SET / RESET pulse
    counts over the cell's two elements (0..2 each).  ``rows``/``cols`` index
    the cells receiving at least one pulse; ``old``/``new`` are their cell
    states before/after.  Class-bit (1T1R) writes are tracked as separate
    pulse totals (``class_set``/``class_reset``) plus a per-row map.
    """

    kind: str                     # 'delta' | 'full'
    shape: tuple[int, int]        # aligned cell-grid shape
    rows: np.ndarray              # (k,) int64 cells with >=1 pulse
    cols: np.ndarray              # (k,) int64
    old: np.ndarray               # (k,) int8 cell state before
    new: np.ndarray               # (k,) int8 cell state after
    set_map: np.ndarray           # (rows, cols) int16 SET pulses per cell
    reset_map: np.ndarray         # (rows, cols) int16 RESET pulses per cell
    n_cells_written: int          # addresses the controller programs
    class_set: int                # 1T1R class-bit SET pulses
    class_reset: int              # 1T1R class-bit RESET pulses
    class_rows: np.ndarray        # (m,) int64 rows with class-bit writes

    @property
    def n_set(self) -> int:
        return int(self.set_map.sum())

    @property
    def n_reset(self) -> int:
        return int(self.reset_map.sum())

    @property
    def n_pulses(self) -> int:
        return self.n_set + self.n_reset + self.class_set + self.class_reset

    @property
    def n_cells_changed(self) -> int:
        """Cells whose state actually differs (== cells pulsed)."""
        return int(self.rows.shape[0])

    @property
    def rows_touched(self) -> int:
        return int(np.union1d(self.rows, self.class_rows).shape[0])

    def apply(self, cells: np.ndarray) -> np.ndarray:
        """Apply the plan to a cell grid (after CELL_X-padding it to the
        plan's aligned shape); returns the programmed grid — used to verify
        that delta programming reproduces the target layout exactly."""
        out = _pad_grid(cells, self.shape).copy()
        out[self.rows, self.cols] = self.new
        return out

    def figures(self, hw: HardwareParams = DEFAULT_HW) -> dict:
        """Energy / time / endurance figures (``core.energy``)."""
        return reprogram_figures(self, hw)

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "cells_written": self.n_cells_written,
            "cells_changed": self.n_cells_changed,
            "rows_touched": self.rows_touched,
            "set_pulses": self.n_set,
            "reset_pulses": self.n_reset,
            "class_set_pulses": self.class_set,
            "class_reset_pulses": self.class_reset,
            "total_pulses": self.n_pulses,
        }


def _aligned(old_cells: np.ndarray, new_cells: np.ndarray):
    old_cells = np.asarray(old_cells)
    new_cells = np.asarray(new_cells)
    shape = (max(old_cells.shape[0], new_cells.shape[0]),
             max(old_cells.shape[1], new_cells.shape[1]))
    return _pad_grid(old_cells, shape), _pad_grid(new_cells, shape), shape


def _element_pulses(old: np.ndarray, new: np.ndarray):
    """(set_map, reset_map) int16 per-cell pulse counts old -> new."""
    r1o, r2o = cell_planes(old)
    r1n, r2n = cell_planes(new)
    set_map = ((~r1o & r1n).astype(np.int16)
               + (~r2o & r2n).astype(np.int16))
    reset_map = ((r1o & ~r1n).astype(np.int16)
                 + (r2o & ~r2n).astype(np.int16))
    return set_map, reset_map


def _class_pulses(old_bits, new_bits, shape_rows: int):
    """1T1R class-bit diff: (set, reset, rows-with-writes)."""
    nb = max(
        0 if old_bits is None else np.asarray(old_bits).shape[1],
        0 if new_bits is None else np.asarray(new_bits).shape[1],
    )
    if nb == 0:
        return 0, 0, np.zeros(0, np.int64)
    ob = _pad_bits(old_bits, (shape_rows, nb)).astype(bool)
    xb = _pad_bits(new_bits, (shape_rows, nb)).astype(bool)
    set_b = ~ob & xb
    reset_b = ob & ~xb
    changed = (set_b | reset_b).any(axis=1)
    return int(set_b.sum()), int(reset_b.sum()), np.flatnonzero(changed)


def plan_delta(
    old_cells: np.ndarray,
    new_cells: np.ndarray,
    *,
    old_class_bits: Optional[np.ndarray] = None,
    new_class_bits: Optional[np.ndarray] = None,
) -> WritePlan:
    """Minimal write plan: pulse only the cells (and class bits) whose state
    differs between the live grid and the candidate grid."""
    old_a, new_a, shape = _aligned(old_cells, new_cells)
    changed = old_a != new_a
    rows, cols = np.nonzero(changed)
    set_map, reset_map = _element_pulses(old_a, new_a)
    # unchanged cells receive no pulses by construction (same state => same
    # element pair), so the maps are already delta-minimal
    cs, cr, crows = _class_pulses(old_class_bits, new_class_bits, shape[0])
    return WritePlan(
        kind="delta",
        shape=shape,
        rows=rows.astype(np.int64),
        cols=cols.astype(np.int64),
        old=old_a[rows, cols],
        new=new_a[rows, cols],
        set_map=set_map,
        reset_map=reset_map,
        n_cells_written=int(changed.sum()),
        class_set=cs,
        class_reset=cr,
        class_rows=crows,
    )


def plan_full(
    old_cells: np.ndarray,
    new_cells: np.ndarray,
    *,
    old_class_bits: Optional[np.ndarray] = None,
    new_class_bits: Optional[np.ndarray] = None,
) -> WritePlan:
    """Naive full reprogramming: erase the whole array (RESET every LRS
    element of the live grid back to HRS), then program every cell of the
    candidate grid (SET its LRS elements).  The controller cycles all
    rows x cols addresses — ``n_cells_written`` is the full grid, and every
    previously-programmed class bit is rewritten."""
    old_a, new_a, shape = _aligned(old_cells, new_cells)
    erased = np.full(shape, CELL_X, dtype=np.int8)
    set_e, reset_e = _element_pulses(old_a, erased)      # erase pass
    set_p, reset_p = _element_pulses(erased, new_a)      # program pass
    set_map = set_e + set_p
    reset_map = reset_e + reset_p
    rows, cols = np.nonzero((set_map + reset_map) > 0)
    nb = max(
        0 if old_class_bits is None else np.asarray(old_class_bits).shape[1],
        0 if new_class_bits is None else np.asarray(new_class_bits).shape[1],
    )
    ob = _pad_bits(old_class_bits, (shape[0], max(nb, 1))).astype(bool)
    xb = _pad_bits(new_class_bits, (shape[0], max(nb, 1))).astype(bool)
    cs = int(xb.sum())                    # program every 1-bit from erased
    cr = int(ob.sum())                    # erase every previously-set bit
    crows = np.flatnonzero(ob.any(axis=1) | xb.any(axis=1)) if nb else \
        np.zeros(0, np.int64)
    return WritePlan(
        kind="full",
        shape=shape,
        rows=rows.astype(np.int64),
        cols=cols.astype(np.int64),
        old=old_a[rows, cols],
        new=new_a[rows, cols],
        set_map=set_map,
        reset_map=reset_map,
        n_cells_written=shape[0] * shape[1],
        class_set=cs,
        class_reset=cr,
        class_rows=crows,
    )


def plan_forest_delta(old_forest, new_forest, *, full: bool = False) -> list:
    """Per-bank write plans migrating one compiled forest to another.

    Banks pair up by index (bank i of the live forest is reprogrammed into
    bank i of the candidate).  A candidate bank beyond the live bank count is
    programmed from an erased array; a live bank beyond the candidate count
    is erased (all its programmed elements RESET).  ``full=True`` emits naive
    full-reprogram plans instead, for comparison.
    """
    old_banks = list(old_forest.banks)
    new_banks = list(new_forest.banks)
    planner = plan_full if full else plan_delta
    plans = []
    for i in range(max(len(old_banks), len(new_banks))):
        ob = old_banks[i] if i < len(old_banks) else None
        cb = new_banks[i] if i < len(new_banks) else None
        oc = ob.layout.cells if ob is not None else np.zeros((0, 0), np.int8)
        ocb = ob.layout.class_bits if ob is not None else None
        if cb is not None:
            nc, ncb = cb.layout.cells, cb.layout.class_bits
        else:
            # retired bank: erase back to all-CELL_X, clear class bits
            nc = np.full_like(oc, CELL_X)
            ncb = None
        plans.append(planner(
            oc, nc, old_class_bits=ocb, new_class_bits=ncb,
        ))
    return plans
