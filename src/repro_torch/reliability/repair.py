"""Spare-row repair: remap defective TCAM rows onto the spare-row pool.

RETENTION-style resource lever: the synthesized array already carries rogue
rows beyond the LUT (``synthesize(..., spare_rows=...)`` guarantees a
minimum), and stuck-at faults are *persistent element* properties — so
repair is a remapping problem:

  1. take the BIST defect map, order defective LUT rows by priority
     (``row_utilization`` supplies traffic-weighted priority — heavy rules
     first — when data is available);
  2. *write-verify* each candidate (row, spare) pair: simulate the row-write
     through the spare's own stuck elements (``apply_saf_mask``) and grade
     the written row's behavior signature against the intended one — clean
     (identical), permissive-only (strictly fewer literals; accepted when
     ``allow_permissive``, the default: a slightly-too-permissive copy beats
     a dead rule), or damaged.  Assign rows to spares by maximum bipartite
     matching (Kuhn's augmenting paths, heavy rows first, clean edges
     preferred) — greedy first-fit strands later rows when compatible spares
     are scarce.  Rows left unmatched fall back to the least-damaged spare,
     taken only when it misbehaves on strictly fewer literal positions than
     the defective original;
  3. disable the defective original (write '1' into its decoder cell so it
     mismatches every query); if the decoder cell itself is stuck
     permissive, fall back to a *poison write* — program any healthy body
     cell to {LRS, LRS} (CELL_MM), which mismatches unconditionally;
  4. copy the row's class into the spare's class memory (classes +
     class_bits re-derived; priority is preserved because disabled originals
     drop out of the first-surviving-row argmax).

Spares are consumed left-to-right; when the pool runs dry the remaining
defective rows are reported in ``RepairReport.unrepaired`` — graceful
degradation, not an exception.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.lut import CELL_1, CELL_MM, CELL_X
from ..core.nonideal import SAFMask, apply_saf_mask
from ..core.synth import TCAMLayout
from ..device import DeviceLike, resolve_device
from ..kernels.ops import tcam_match
from .bist import row_match, row_signatures

__all__ = ["RepairReport", "repair_layout", "row_utilization",
           "row_utilization_ref"]


@dataclasses.dataclass
class RepairReport:
    """Outcome of one repair pass (graceful-degradation accounting)."""

    assignments: dict[int, int]       # defective LUT row -> spare row
    permissive: list[int]             # spares accepted permissive-only
    best_effort: list[int]            # spares taken damaged-but-better
    disabled: list[int]               # originals successfully disabled
    ghosts: list[int]                 # rows that could not be silenced
    unrepaired: list[int]             # defective rows with no usable spare
    spares_used: int
    spares_left: int

    @property
    def degraded(self) -> bool:
        """True when the chip still misbehaves after repair (spares
        exhausted or un-silenceable ghost rows)."""
        return bool(self.unrepaired or self.ghosts)

    @property
    def rows_repaired(self) -> int:
        return len(self.assignments)

    @property
    def blocked_rows(self) -> np.ndarray:
        """Physical rows that must not receive live content in a later
        reprogramming pass: defective originals remapped onto spares, rows
        left unrepaired, and un-silenceable ghosts.  This is the composition
        point with the lifecycle wear-leveling remapper
        (``lifecycle.wear_level_rows(..., forbidden=report.blocked_rows)``).
        """
        return np.unique(np.asarray(
            list(self.assignments.keys()) + self.unrepaired + self.ghosts,
            dtype=np.int64,
        ))

    def summary(self) -> dict:
        return {
            "rows_repaired": self.rows_repaired,
            "permissive_repairs": len(self.permissive),
            "best_effort_repairs": len(self.best_effort),
            "disabled": len(self.disabled),
            "ghosts": len(self.ghosts),
            "unrepaired": len(self.unrepaired),
            "spares_used": self.spares_used,
            "spares_left": self.spares_left,
            "degraded": self.degraded,
        }


def first_survivors(layout: TCAMLayout, xbits: np.ndarray, *,
                    device: DeviceLike = None) -> torch.Tensor:
    """(B,) int64 on ``device``: each encoded input's first surviving row,
    -1 where no row survives.

    One launch of the match kernel on ``device`` (``kernels.tcam_match``,
    engine 'auto', kmax 0: a row survives iff every unmasked cell matches,
    as ``row_match``), with the masked columns beyond ``1 + width`` held
    don't-care as ``row_match`` ignores them."""
    dev = resolve_device(device)
    cells = np.array(layout.cells, copy=True)
    cells[:, 1 + layout.width:] = CELL_X
    xpad = layout.pad_inputs(np.asarray(xbits, np.uint8))
    survive, _ = tcam_match(cells, xpad, layout.s, device=dev)
    first = torch.argmax(survive, dim=1)
    return torch.where(survive.any(dim=1), first, -1)


def row_utilization(layout: TCAMLayout, xbits: np.ndarray, *,
                    device: DeviceLike = None) -> np.ndarray:
    """(R,) hit counts: how many encoded inputs each row serves (first
    surviving row wins, matching the engine's argmax).  Use on the *ideal*
    layout with training data to prioritize repair of heavy rules.

    The first survivors come from one launch of the match kernel
    (``first_survivors``) and are counted on the device;
    ``row_utilization_ref`` is the plain version."""
    first = first_survivors(layout, xbits, device=device)
    return torch.bincount(first[first >= 0],
                          minlength=layout.cells.shape[0]).cpu().numpy()


def row_utilization_ref(layout: TCAMLayout, xbits: np.ndarray) -> np.ndarray:
    """The plain version of ``row_utilization``: every row against every
    input on the host, as (R, B) booleans."""
    xpad = layout.pad_inputs(np.asarray(xbits, np.uint8))
    m = row_match(layout.cells, xpad, 1 + layout.width)      # (R, B)
    hit = m.any(axis=0)
    first = np.argmax(m, axis=0)
    return np.bincount(first[hit], minlength=layout.cells.shape[0])


def _mask_rows(mask: SAFMask, idx: np.ndarray) -> SAFMask:
    return SAFMask(
        sa0_r1=mask.sa0_r1[idx], sa1_r1=mask.sa1_r1[idx],
        sa0_r2=mask.sa0_r2[idx], sa1_r2=mask.sa1_r2[idx],
    )


def _max_matching(adj: list[list[int]]) -> dict[int, int]:
    """Kuhn's augmenting-path maximum bipartite matching.

    ``adj[i]`` lists candidate spare positions for row position ``i`` in
    preference order (clean before permissive).  Rows are offered in input
    order, so higher-priority rows get first claim on scarce spares.
    Returns ``{row position: spare position}``."""
    match: dict[int, int] = {}        # spare position -> row position

    def aug(i: int, seen: set) -> bool:
        for j in adj[i]:
            if j in seen:
                continue
            seen.add(j)
            if j not in match or aug(match[j], seen):
                match[j] = i
                return True
        return False

    for i in range(len(adj)):
        aug(i, set())
    return {i: j for j, i in match.items()}


def _disable_row(
    intent: np.ndarray, mask: SAFMask, row: int, used: int
) -> bool:
    """Silence one physical row in place; True on success.

    Primary: write '1' into the decoder cell (queries carry '0' there).
    Fallback: poison-write CELL_MM into the first body cell whose two
    elements are both free of stuck-at-HRS (a full {LRS,LRS} write needs
    both elements to reach LRS)."""
    intent[row, 0] = CELL_1
    actual = apply_saf_mask(intent[row][None, :], _mask_rows(mask, [row]))
    if row_signatures(actual, used)[0][0]:
        return True
    for c in range(1, used):
        if not (mask.sa0_r1[row, c] or mask.sa0_r2[row, c]):
            intent[row, c] = CELL_MM
            return True
    return False


def repair_layout(
    layout: TCAMLayout,
    intent_cells: np.ndarray,
    mask: SAFMask,
    defect_rows: np.ndarray,
    *,
    allow_permissive: bool = True,
    priority: Optional[np.ndarray] = None,
) -> tuple[TCAMLayout, np.ndarray, RepairReport]:
    """Remap defective rows onto write-verified spares.

    layout: the chip as it currently responds (``cells`` already faulted).
    intent_cells: the content the controller programmed (ideal initially).
    mask: the chip's persistent stuck-element state.
    defect_rows: physical row indices flagged by BIST.
    priority: optional per-row score — higher repaired first (defaults to
        row order, i.e. LUT priority order).

    Returns ``(new_layout, new_intent, report)``; ``new_layout.cells`` is
    the post-repair chip response (``apply_saf_mask(new_intent, mask)``).
    """
    used = 1 + layout.width
    intent = np.array(intent_cells, copy=True)
    classes = np.array(layout.classes, copy=True)
    class_bits = np.array(layout.class_bits, copy=True)
    defect_rows = np.asarray(defect_rows, dtype=int)

    # free spares: rogue rows still programmed to their pristine dead intent
    spare_idx = layout.spare_row_indices
    free = [int(j) for j in spare_idx if intent[j, 0] == CELL_1]

    # defective LUT rows whose intent is still an alive rule
    dead_i = row_signatures(intent, used)[0]
    todo = [int(r) for r in defect_rows if r < layout.n_rows and not dead_i[r]]
    if priority is not None:
        todo.sort(key=lambda r: -float(priority[r]))

    assignments: dict[int, int] = {}
    permissive_rows: list[int] = []
    best_effort_rows: list[int] = []
    disabled: list[int] = []
    ghosts: list[int] = []
    unrepaired: list[int] = []

    n_t, n_s = len(todo), len(free)
    if n_t and n_s:
        todo_arr = np.asarray(todo)
        j_arr = np.asarray(free)
        spare_masks = _mask_rows(mask, j_arr)

        # write-verify every (row, spare) pair: grade 2 = clean copy,
        # 1 = permissive-only, 0 = damaged; damage = # misbehaving literals
        CLEAN, PERM = 2, 1
        grade = np.zeros((n_t, n_s), np.int8)
        damage = np.full((n_t, n_s), np.inf)
        _, zi_t, oi_t = row_signatures(intent[todo_arr], used)
        for i, r in enumerate(todo):
            written = apply_saf_mask(
                np.repeat(intent[r][None, :], n_s, axis=0), spare_masks
            )
            d, z, o = row_signatures(written, used)
            zi, oi = zi_t[i], oi_t[i]
            lit_diff = (z != zi).sum(axis=1) + (o != oi).sum(axis=1)
            perm = ~d & ~(z & ~zi).any(axis=1) & ~(o & ~oi).any(axis=1)
            grade[i, ~d & (lit_diff == 0)] = CLEAN
            grade[i, perm & (grade[i] != CLEAN)] = PERM
            damage[i] = np.where(d, np.inf, lit_diff)

        # how badly does the *unrepaired original* already misbehave?
        da, za, oa = row_signatures(layout.cells[todo_arr], used)
        orig_damage = np.where(
            da, used + 1,
            (za != zi_t).sum(axis=1) + (oa != oi_t).sum(axis=1),
        )

        adj = []
        for i in range(n_t):
            cl = np.flatnonzero(grade[i] == CLEAN).tolist()
            pm = (np.flatnonzero(grade[i] == PERM).tolist()
                  if allow_permissive else [])
            adj.append(cl + pm)
        row2spare = _max_matching(adj)

        taken = set(row2spare.values())
        for i, r in enumerate(todo):
            pick = row2spare.get(i)
            kind = None
            if pick is not None:
                kind = "perm" if grade[i, pick] < CLEAN else "clean"
            elif allow_permissive:
                # best-effort: least-damaged leftover spare, only if it
                # misbehaves on strictly fewer literals than the original
                open_pos = [s for s in range(n_s) if s not in taken]
                if open_pos:
                    s = min(open_pos, key=lambda s: damage[i, s])
                    if damage[i, s] < orig_damage[i]:
                        pick, kind = s, "best_effort"
            if pick is None:
                unrepaired.append(r)
                continue
            taken.add(pick)
            j = int(j_arr[pick])
            intent[j] = intent[r]
            assignments[r] = j
            if kind == "perm":
                permissive_rows.append(j)
            elif kind == "best_effort":
                best_effort_rows.append(j)
            classes[j] = classes[r]
            class_bits[j] = class_bits[r]
            if _disable_row(intent, mask, r, used):
                disabled.append(r)
            else:
                ghosts.append(r)
        free = [int(j_arr[s]) for s in range(n_s) if s not in taken]
    else:
        unrepaired.extend(todo)

    # ghost spares: rogue rows that BIST caught responding despite a dead
    # intent — silence them so they cannot steal queries with random classes
    for r in defect_rows:
        r = int(r)
        if r >= layout.n_rows and r not in assignments.values():
            if not _disable_row(intent, mask, r, used):
                ghosts.append(r)

    new_cells = apply_saf_mask(intent, mask)
    # padding columns beyond decoder+LUT width are OFF-OFF (masked) — faults
    # there never reach the match line; keep the served grid don't-care
    new_cells[:, used:] = CELL_X
    new_layout = dataclasses.replace(
        layout, cells=new_cells, classes=classes, class_bits=class_bits
    )
    report = RepairReport(
        assignments=assignments,
        permissive=permissive_rows,
        best_effort=best_effort_rows,
        disabled=disabled,
        ghosts=ghosts,
        unrepaired=unrepaired,
        spares_used=len(assignments),
        spares_left=len(free),
    )
    return new_layout, intent, report
