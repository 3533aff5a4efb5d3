"""Scrub-and-refresh scheduling for drifting ReCAM arrays.

A *scrub* reads a region's intended content and rewrites it in place; the
rewrite resets every element's drift clock (conductance walks restart from
the freshly-programmed state).  The scheduler's job is deciding *when* to
refresh *which* rows, trading refresh energy + endurance pulses against the
accuracy loss of serving from out-of-margin cells:

* ``periodic`` policy — refresh any row older than ``period_s`` (DRAM-style
  blanket refresh; simple, ignores the actual margins).
* ``margin`` policy — refresh rows whose worst-case sensing margin (from
  ``core.energy.sensing_margins`` over the drifted resistances) fell below
  ``margin_v`` (condition-based; touches only the rows that need it).

Refreshes are lowered through the lifecycle write machinery: ``plan_refresh``
emits a ``WritePlan`` (kind ``"refresh"``) whose SET/RESET pulse maps feed
``core.energy.reprogram_figures`` (energy/time) and
``lifecycle.WearTracker.record`` (endurance) exactly like a redeploy — a
scrubbing deployment sees its refresh overhead in the same ledgers as its
model updates.

The per-row clocks, read counts and refresh plans are small host arrays, as
in the JAX package; ``layout_margins`` runs the drifted resistances and the
margins as tensor ops on the drift model's device (``layout_margins_ref``:
the same through the copied numpy bodies).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from ..core.energy import (DEFAULT_HW, HardwareParams, sensing_margins,
                           sensing_margins_ref)
from ..core.lut import CELL_0, CELL_1
from ..core.nonideal import DriftModel
from ..lifecycle.delta import WritePlan, cell_planes

__all__ = ["ScrubPolicy", "ScrubReport", "ScrubScheduler", "layout_margins",
           "layout_margins_ref", "plan_refresh"]


@dataclasses.dataclass(frozen=True)
class ScrubPolicy:
    """When is a row due for refresh?

    kind='margin': when its sensing margin drops to <= ``margin_v`` volts.
    kind='periodic': when its age since last write reaches ``period_s``.
    ``max_rows`` bounds one scrub pass (worst rows first); None = unbounded.
    """

    kind: str = "margin"
    margin_v: float = 0.15
    period_s: float = 3600.0
    max_rows: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind not in ("margin", "periodic"):
            raise ValueError(
                f"unknown scrub policy kind {self.kind!r} "
                "(expected 'margin' or 'periodic')"
            )
        if self.period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")
        if self.max_rows is not None and self.max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {self.max_rows}")


def plan_refresh(
    cells: np.ndarray,
    rows: Iterable[int],
    *,
    used: Optional[int] = None,
) -> WritePlan:
    """Refresh plan: one reinforcing pulse per resistive element of every
    cell in ``rows`` over the first ``used`` columns (SET for an LRS element,
    RESET for an HRS element — re-asserting the programmed state).

    The plan's ``old == new`` (a refresh changes no cell *state*), so
    ``apply()`` is the identity; what it carries is the pulse maps — the
    energy/time/endurance cost of the pass.
    """
    cells = np.asarray(cells)
    n_rows, n_cols = cells.shape
    used = n_cols if used is None else min(used, n_cols)
    rows = np.unique(np.asarray(list(rows), dtype=np.int64))
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("refresh row index out of range")

    r1_lrs, r2_lrs = cell_planes(cells)
    sel = np.zeros((n_rows, n_cols), dtype=bool)
    sel[rows, :used] = True
    set_map = (sel & r1_lrs).astype(np.int16) + (sel & r2_lrs).astype(np.int16)
    reset_map = (sel & ~r1_lrs).astype(np.int16) \
        + (sel & ~r2_lrs).astype(np.int16)
    rr, cc = np.nonzero(sel)
    return WritePlan(
        kind="refresh",
        shape=(n_rows, n_cols),
        rows=rr.astype(np.int64),
        cols=cc.astype(np.int64),
        old=cells[rr, cc],
        new=cells[rr, cc],
        set_map=set_map,
        reset_map=reset_map,
        n_cells_written=int(sel.sum()),
        class_set=0,
        class_reset=0,
        class_rows=np.zeros(0, np.int64),
    )


def layout_margins(
    layout,
    drift: DriftModel,
    t_since_write,
    reads_since_write,
    hw: HardwareParams = DEFAULT_HW,
):
    """Per-row ``SenseMargins`` of a layout under drift.

    ``layout`` is duck-typed (needs ``cells``, ``s``, ``width``);
    ``t_since_write`` / ``reads_since_write`` are per-row or scalar, usually
    straight from a ``ScrubScheduler``.  Only determinate (CELL_0/CELL_1)
    cells can mismatch; CELL_X don't-cares contribute match-branch
    conductance only, mirroring the functional simulator.  The grid goes to
    the drift model's device once; resistances and margins are tensor ops
    there.
    """
    cells = torch.as_tensor(layout.cells, device=drift.device)
    r_match, r_mismatch = drift.cell_resistances(
        cells, t_since_write, reads_since_write, hw
    )
    return sensing_margins(
        r_match, r_mismatch,
        s=int(layout.s), used=1 + int(layout.width), hw=hw,
        determinate=(cells == CELL_0) | (cells == CELL_1),
    )


def layout_margins_ref(
    layout,
    drift: DriftModel,
    t_since_write,
    reads_since_write,
    hw: HardwareParams = DEFAULT_HW,
):
    """``layout_margins`` through the copied numpy bodies
    (``DriftModel.cell_resistances_ref``, ``sensing_margins_ref``)."""
    cells = np.asarray(layout.cells)
    r_match, r_mismatch = drift.cell_resistances_ref(
        cells, t_since_write, reads_since_write, hw
    )
    return sensing_margins_ref(
        r_match, r_mismatch,
        s=int(layout.s), used=1 + int(layout.width), hw=hw,
        determinate=np.isin(cells, (CELL_0, CELL_1)),
    )


@dataclasses.dataclass(frozen=True)
class ScrubReport:
    """Outcome of one scrub pass."""

    t: float                      # virtual time of the pass
    policy: str                   # policy kind that selected the rows
    rows_due: int                 # rows the policy wanted refreshed
    rows_refreshed: np.ndarray    # (k,) rows actually refreshed
    rows_skipped: np.ndarray      # (m,) due rows excluded (blocked/capped)
    figures: dict                 # reprogram_figures of the refresh plan
    margin_min_v: Optional[float]  # worst pre-scrub margin (margin policy)

    @property
    def n_refreshed(self) -> int:
        return int(self.rows_refreshed.shape[0])

    def summary(self) -> dict:
        return {
            "t": self.t,
            "policy": self.policy,
            "rows_due": self.rows_due,
            "rows_refreshed": self.n_refreshed,
            "rows_skipped": int(self.rows_skipped.shape[0]),
            "pulses": self.figures["pulses"],
            "energy_j": self.figures["energy_j"],
            "time_s": self.figures["time_s"],
            "margin_min_v": self.margin_min_v,
        }


class ScrubScheduler:
    """Per-row stress bookkeeping + refresh scheduling on a virtual clock.

    Tracks, for one physical array of ``n_rows`` rows: the virtual time each
    row was last (re)written and the searches it has served since — the
    ``(time_since_write, reads_since_write)`` pair ``DriftModel`` evolves
    resistances over.  ``advance``/``note_reads`` are driven by the serving
    loop; ``note_write`` by any programming pass (redeploy, repair, refresh).

    Composition: pass ``wear=`` a ``lifecycle.WearTracker`` and every refresh
    plan executed through ``scrub()`` debits the shared endurance ledger;
    pass ``blocked=`` (e.g. ``RepairReport.blocked_rows``) to ``due``/
    ``scrub`` so decoder-disabled rows are never refreshed — they carry no
    live content and the pulses would be wasted endurance.
    """

    def __init__(
        self,
        n_rows: int,
        *,
        policy: ScrubPolicy = ScrubPolicy(),
        wear=None,
        hw: HardwareParams = DEFAULT_HW,
    ) -> None:
        if n_rows < 1:
            raise ValueError(f"n_rows must be >= 1, got {n_rows}")
        self.policy = policy
        self.wear = wear
        self.hw = hw
        self.now = 0.0
        self.t_written = np.zeros(n_rows, dtype=np.float64)
        self.reads = np.zeros(n_rows, dtype=np.int64)
        self.scrubs = 0
        self.rows_refreshed_total = 0
        self.refresh_energy_j = 0.0
        self.refresh_pulses = 0

    @property
    def n_rows(self) -> int:
        return int(self.t_written.shape[0])

    # -- stress clock ------------------------------------------------------
    def advance(self, dt: float) -> float:
        """Advance the virtual clock by dt seconds; returns the new now."""
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        self.now += float(dt)
        return self.now

    def note_reads(self, n: int = 1,
                   rows: Optional[Iterable[int]] = None) -> None:
        """Record n searches against all rows (every search precharges and
        senses every live row in the first column division) or against a
        subset."""
        if rows is None:
            self.reads += int(n)
        else:
            self.reads[np.asarray(list(rows), dtype=np.int64)] += int(n)

    def note_write(self, rows: Optional[Iterable[int]] = None) -> None:
        """A programming pass rewrote these rows (None = whole array): their
        drift clocks restart."""
        if rows is None:
            self.t_written[:] = self.now
            self.reads[:] = 0
        else:
            idx = np.asarray(list(rows), dtype=np.int64)
            self.t_written[idx] = self.now
            self.reads[idx] = 0

    def ages(self) -> np.ndarray:
        """(rows,) seconds since each row's last write."""
        return self.now - self.t_written

    # -- scheduling --------------------------------------------------------
    def _hit(self, margins: Optional[np.ndarray]) -> np.ndarray:
        """All rows the policy flags, worst-first, before blocked/cap."""
        if self.policy.kind == "margin":
            if margins is None:
                raise ValueError("margin policy needs per-row margins")
            margins = np.asarray(margins, dtype=np.float64)
            if margins.shape != (self.n_rows,):
                raise ValueError(
                    f"margins shape {margins.shape} != ({self.n_rows},)"
                )
            hit = margins <= self.policy.margin_v
            order = np.argsort(margins, kind="stable")  # worst margin first
        else:
            age = self.ages()
            hit = age >= self.policy.period_s
            order = np.argsort(-age, kind="stable")     # oldest first
        return order[hit[order]].astype(np.int64)

    def due(
        self,
        margins: Optional[np.ndarray] = None,
        *,
        blocked: Iterable[int] = (),
    ) -> np.ndarray:
        """Rows due for refresh under the policy, worst-first, minus
        ``blocked``, capped at ``policy.max_rows``.

        The margin policy needs ``margins`` — the per-row overall margin
        (``SenseMargins.margin`` / ``layout_margins(...)``, computed by the
        caller who owns the ``DriftModel``).
        """
        due = self._hit(margins)
        blocked = np.asarray(list(blocked), dtype=np.int64)
        if blocked.size:
            due = due[~np.isin(due, blocked)]
        if self.policy.max_rows is not None:
            due = due[: self.policy.max_rows]
        return due

    def scrub(
        self,
        cells: np.ndarray,
        margins: Optional[np.ndarray] = None,
        *,
        used: Optional[int] = None,
        blocked: Iterable[int] = (),
        force_rows: Optional[Iterable[int]] = None,
    ) -> tuple[WritePlan, ScrubReport]:
        """One scrub pass: select due rows (or ``force_rows``), emit the
        refresh plan, debit the wear ledger, restart the rows' drift clocks.

        Returns (plan, report); the *caller* owns rewriting the physical
        array contents from the intent (in simulation: re-deriving the
        served grid from the intent at zero drift).
        """
        blocked = np.asarray(list(blocked), dtype=np.int64)
        if force_rows is not None:
            want = np.unique(np.asarray(list(force_rows), dtype=np.int64))
        else:
            want = self._hit(margins)
        due = want[~np.isin(want, blocked)] if blocked.size else want
        if force_rows is None and self.policy.max_rows is not None:
            due = due[: self.policy.max_rows]
        plan = plan_refresh(cells, due, used=used)
        figs = plan.figures(self.hw)
        if due.size:
            if self.wear is not None:
                self.wear.record(plan)
            self.note_write(due)
        self.scrubs += 1
        self.rows_refreshed_total += int(due.size)
        self.refresh_energy_j += figs["energy_j"]
        self.refresh_pulses += figs["pulses"]
        report = ScrubReport(
            t=self.now,
            policy="forced" if force_rows is not None else self.policy.kind,
            rows_due=int(want.size),
            rows_refreshed=due,
            rows_skipped=np.setdiff1d(want, due),
            figures=figs,
            margin_min_v=(float(np.min(margins))
                          if margins is not None and np.size(margins)
                          else None),
        )
        return plan, report

    def snapshot(self) -> dict:
        ages = self.ages()
        return {
            "now_s": self.now,
            "rows": self.n_rows,
            "max_age_s": float(ages.max()) if ages.size else 0.0,
            "max_reads": int(self.reads.max()) if self.reads.size else 0,
            "scrub_passes": self.scrubs,
            "rows_refreshed_total": self.rows_refreshed_total,
            "refresh_energy_j": self.refresh_energy_j,
            "refresh_pulses": self.refresh_pulses,
            "policy": dataclasses.asdict(self.policy),
        }
