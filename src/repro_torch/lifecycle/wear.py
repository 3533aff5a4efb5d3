"""Per-cell endurance tracking and the wear-leveling row remapper.

ReRAM elements survive a finite number of program pulses
(``HardwareParams.endurance_writes``).  ``WearTracker`` accumulates the pulse
maps of every executed ``WritePlan`` so a deployment knows, per cell, how
much endurance each redeploy consumed and which cells are approaching
failure.

``wear_level_rows`` is the placement half of the endurance story: TCAM rows
of a reduced decision tree are mutually exclusive rules (disjoint tree
paths), so the *physical* row a rule lands on is a free variable.  The
remapper assigns each logical LUT row of a candidate layout to a physical
row chosen to minimize

    write pulses needed (element diff vs. the row's current content)
      + alpha * mean accumulated wear of the physical row,

greedily in LUT-priority order — similar retrained rules land on the rows
that already hold their closest predecessor (fewer writes), and repeated
redeploys spread programming across the array instead of hammering row 0..R.
Physical rows listed in ``forbidden`` (defective rows from a spare-row
``RepairReport`` — compose via ``report.blocked_rows`` — or worn-out rows
from the tracker) never receive live content; any such row whose current
decoder cell would still match queries is disabled in the remapped intent.

The remapped layout is functionally identical to the candidate (same rules,
same classes — verified by the lifecycle tests); only physical row indices
and therefore ``SimResult.survivors`` values change.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from ..core.energy import DEFAULT_HW, HardwareParams
from ..core.lut import CELL_1, CELL_X
from ..core.synth import TCAMLayout
from .delta import WritePlan, cell_planes

__all__ = ["WearTracker", "RemapResult", "wear_level_rows"]


class WearTracker:
    """Accumulated per-cell program-pulse counts for one physical array.

    ``record`` adds a ``WritePlan``'s pulse maps (cell pulses land on the
    cell grid; class-bit pulses are tracked as a scalar).  The grid grows
    automatically when a plan's aligned shape exceeds the current one —
    modelling an array sized for the largest layout it ever held.
    """

    def __init__(self, shape: tuple[int, int] = (0, 0),
                 *, hw: HardwareParams = DEFAULT_HW) -> None:
        self.hw = hw
        self.counts = np.zeros(shape, dtype=np.int64)
        self.class_pulses = 0
        self.plans_recorded = 0

    def _grow(self, shape: tuple[int, int]) -> None:
        r = max(self.counts.shape[0], shape[0])
        c = max(self.counts.shape[1], shape[1])
        if (r, c) != self.counts.shape:
            grown = np.zeros((r, c), dtype=np.int64)
            grown[: self.counts.shape[0], : self.counts.shape[1]] = self.counts
            self.counts = grown

    def record(self, plan: WritePlan) -> None:
        self._grow(plan.shape)
        self.counts[: plan.shape[0], : plan.shape[1]] += plan.set_map
        self.counts[: plan.shape[0], : plan.shape[1]] += plan.reset_map
        self.class_pulses += plan.class_set + plan.class_reset
        self.plans_recorded += 1

    # -- endurance accounting ----------------------------------------------
    @property
    def total_pulses(self) -> int:
        return int(self.counts.sum()) + self.class_pulses

    @property
    def max_cell_pulses(self) -> int:
        return int(self.counts.max()) if self.counts.size else 0

    def row_wear(self) -> np.ndarray:
        """(rows,) mean pulses per cell of each physical row."""
        if self.counts.size == 0:
            return np.zeros(0, np.float64)
        return self.counts.mean(axis=1)

    def headroom(self) -> float:
        """Remaining endurance fraction of the most-worn cell (1.0 = fresh,
        <= 0.0 = some cell exceeded its rated endurance)."""
        return 1.0 - self.max_cell_pulses / self.hw.endurance_writes

    def worn_out(self) -> np.ndarray:
        """Boolean grid of cells at/past their rated endurance."""
        return self.counts >= self.hw.endurance_writes

    def worn_rows(self) -> np.ndarray:
        """Physical rows containing at least one worn-out cell — candidates
        for ``wear_level_rows(..., forbidden=...)``."""
        if self.counts.size == 0:
            return np.zeros(0, np.int64)
        return np.flatnonzero(self.worn_out().any(axis=1))

    def snapshot(self) -> dict:
        return {
            "plans_recorded": self.plans_recorded,
            "total_pulses": self.total_pulses,
            "max_cell_pulses": self.max_cell_pulses,
            "mean_cell_pulses": (
                float(self.counts.mean()) if self.counts.size else 0.0
            ),
            "headroom": self.headroom(),
            "worn_cells": int(self.worn_out().sum()),
            "endurance_writes": self.hw.endurance_writes,
        }


def _pulse_cost_matrix(new_rows: np.ndarray,
                       phys_rows: np.ndarray) -> np.ndarray:
    """(L, P) pulses needed to program logical row i onto physical row p:
    element diffs counted via the two LRS bitplanes (two matmuls each)."""
    costs = np.zeros((new_rows.shape[0], phys_rows.shape[0]), np.int64)
    for plane_n, plane_p in zip(cell_planes(new_rows), cell_planes(phys_rows)):
        a = plane_n.astype(np.int64)
        b = plane_p.astype(np.int64)
        # differing elements = a XOR b summed over columns, as matmuls
        costs += a @ (1 - b).T + (1 - a) @ b.T
    return costs


@dataclasses.dataclass
class RemapResult:
    layout: TCAMLayout            # candidate layout with rows re-placed
    row_map: np.ndarray           # (n_rows,) logical LUT row -> physical row
    forbidden: np.ndarray         # (f,) physical rows excluded from placement

    def summary(self) -> dict:
        ident = np.arange(self.row_map.shape[0])
        return {
            "rows_mapped": int(self.row_map.shape[0]),
            "rows_moved": int((self.row_map != ident).sum()),
            "forbidden_rows": int(self.forbidden.shape[0]),
        }


def wear_level_rows(
    candidate: TCAMLayout,
    current_cells: np.ndarray,
    wear: Optional[WearTracker] = None,
    *,
    forbidden: Iterable[int] = (),
    alpha: float = 1.0,
) -> RemapResult:
    """Re-place the candidate layout's logical rows onto physical rows.

    candidate: the compiled layout about to be delta-programmed.
    current_cells: the physical array's current contents (the live intent),
        CELL_X-padded/cropped to the candidate grid automatically.
    wear: accumulated endurance state (None = fresh array, pure
        write-minimisation).
    forbidden: physical rows that must not host live content (defective rows
        from ``RepairReport.blocked_rows``, worn rows from
        ``WearTracker.worn_rows``).
    alpha: wear-avoidance weight — pulses a row's mean historical wear is
        worth during placement (0 = ignore wear entirely).

    Returns a ``RemapResult`` whose ``layout`` matches the candidate
    functionally; physical rows left without a logical row are given a dead
    intent (decoder CELL_1, body CELL_X) so stale rules cannot ghost-match.
    """
    cand_cells = np.asarray(candidate.cells)
    n_phys, width = cand_cells.shape
    n_log = candidate.n_rows
    cur = np.full((n_phys, width), CELL_X, dtype=np.int8)
    src = np.asarray(current_cells)
    r = min(src.shape[0], n_phys)
    c = min(src.shape[1], width)
    cur[:r, :c] = src[:r, :c]

    forbidden = np.unique(np.asarray(list(forbidden), dtype=np.int64)) \
        if not isinstance(forbidden, np.ndarray) else np.unique(forbidden)
    if forbidden.size and (forbidden.min() < 0 or forbidden.max() >= n_phys):
        raise ValueError("forbidden row index out of range")
    allowed = np.setdiff1d(np.arange(n_phys), forbidden)
    if allowed.size < n_log:
        raise ValueError(
            f"cannot place {n_log} logical rows on {allowed.size} allowed "
            f"physical rows ({forbidden.size} forbidden of {n_phys})"
        )

    cost = _pulse_cost_matrix(
        cand_cells[:n_log], cur[allowed]
    ).astype(np.float64)
    if wear is not None and alpha > 0.0:
        rw = np.zeros(n_phys, np.float64)
        hist = wear.row_wear()
        k = min(hist.shape[0], n_phys)
        rw[:k] = hist[:k]
        cost = cost + alpha * rw[allowed][None, :]

    # greedy in LUT-priority order: each logical row takes the cheapest
    # still-open physical slot
    taken = np.zeros(allowed.size, dtype=bool)
    row_map = np.empty(n_log, dtype=np.int64)
    for i in range(n_log):
        open_cost = np.where(taken, np.inf, cost[i])
        pick = int(np.argmin(open_cost))
        taken[pick] = True
        row_map[i] = allowed[pick]

    # dead intent everywhere first (decoder '1' forces mismatch), then place
    # logical row i at physical row_map[i]; its class rides along.  Unplaced
    # rows keep the candidate's rogue-row classes — they are dead anyway.
    cells = np.full((n_phys, width), CELL_X, dtype=np.int8)
    cells[:, 0] = CELL_1
    cells[row_map] = cand_cells[:n_log]
    classes = np.array(candidate.classes, copy=True)
    class_bits = np.array(candidate.class_bits, copy=True)
    classes[row_map] = candidate.classes[:n_log]
    class_bits[row_map] = candidate.class_bits[:n_log]

    layout = dataclasses.replace(
        candidate, cells=cells, classes=classes, class_bits=class_bits
    )
    return RemapResult(layout=layout, row_map=row_map, forbidden=forbidden)
