"""March-style built-in self-test (BIST) for TCAM arrays.

A deployed chip cannot be read cell-by-cell; its only observable is the
match/mismatch response to search words.  The BIST therefore probes each
physical row with a small synthesized test set and compares the *observed*
response against the *intended* response (what the row was programmed to
hold), in the spirit of march tests for CAMs:

  M0 (stored-word element): the row's own matching word — every intended
      literal satisfied.  A healthy row matches; a row with any restrictive
      fault (``X -> 0/1`` flip, ``{LRS,LRS}`` always-mismatch cell, decoder
      corruption) responds differently from intent.
  M1 (walking-bit element): flip one body bit of M0 at a time.  A healthy
      row mismatches exactly at its literal positions; a permissive fault
      (``0/1 -> X``) matches where it should not, a flipped literal
      mismatches where it should not.
  M2/M3 (readback elements): the same two probe families synthesized from
      the *observed* cell state (2T2R cells are resistive memory with a read
      port — readback is how a controller verifies writes).  Intent-derived
      probes alone can miss a row whose intent is dead but whose faults
      brought it alive with several 1-literals: no single walking bit
      satisfies all of them at once.  The actual row's own characteristic
      word does, exposing the rogue.

The decoder bit (column 0) is held at the query value '0' throughout —
probes only cover inputs the chip can actually see, so rows whose faults are
behaviorally invisible to real queries are (correctly) not flagged.

``run_bist`` evaluates every probe of every row at once with tensor ops on
the device, without building a probe matrix: a probe family is a base word
plus its single-bit flips, so a row's response to the whole family follows
from its per-column agreement with the base word.  ``run_bist_ref`` is the
plain version, a loop over rows that synthesizes each row's probes
(``march_probes``) and matches them (``row_match``).

``row_signatures`` / ``behavior_changed_rows`` give the analytic ground
truth — two rows respond identically to every reachable query iff their
(dead?, 0-literal set, 1-literal set) signatures agree — used for coverage
accounting in tests and the chaos harness.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.lut import CELL_0, CELL_1, CELL_MM, CELL_X
from ..core.synth import TCAMLayout
from ..device import DeviceLike, resolve_device

__all__ = [
    "BistReport", "march_probes", "row_match", "row_signatures",
    "behavior_changed_rows", "run_bist", "run_bist_ref", "bist_layout",
]


def _packed64(mask: np.ndarray) -> np.ndarray:
    """(N, n) booleans -> (N, ceil(n / 64)) uint64 bit words."""
    b = np.packbits(mask, axis=1)
    pad = -b.shape[1] % 8
    if pad:
        b = np.pad(b, ((0, 0), (0, pad)))
    return np.ascontiguousarray(b).view(np.uint64)


def row_match(cells: np.ndarray, words: np.ndarray, used: int) -> np.ndarray:
    """Evaluate search words against rows of cells; (R, P) booleans.

    A row survives iff every unmasked cell (columns ``[0, used)``) matches:
    CELL_X matches both bits, CELL_0/1 match their bit, CELL_MM matches
    neither.  Columns beyond ``used`` are masked (OFF-OFF) and ignored —
    identical to the oracle's final survive with kmax=0.

    Evaluated on 64-column bit words: a row fails a word where a cell that
    rejects 1 meets a 1, a cell that rejects 0 meets a 0, or a cared cell
    meets any other value; a few words at a time, so the (R, P, words)
    temporaries stay near 32 MB.
    """
    cells = np.atleast_2d(np.asarray(cells))[:, :used]       # (R, used)
    words = np.atleast_2d(np.asarray(words))[:, :used]       # (P, used)
    care = cells != CELL_X
    rej1 = _packed64(care & (cells != CELL_1))               # CELL_0, MM
    rej0 = _packed64(care & (cells != CELL_0))               # CELL_1, MM
    care = _packed64(care)
    is1, is0 = words == 1, words == 0
    one, zero, other = (_packed64(m) for m in (is1, is0, ~(is1 | is0)))
    out = np.empty((cells.shape[0], words.shape[0]), bool)
    step = max(1, (1 << 22) // max(1, rej1.size))
    for p in range(0, words.shape[0], step):
        q = slice(p, p + step)
        bad = ((rej1[:, None] & one[None, q]) | (rej0[:, None] & zero[None, q])
               | (care[:, None] & other[None, q]))
        out[:, q] = ~bad.any(axis=2)
    return out


def row_signatures(
    cells: np.ndarray, used: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Analytic behavior signature of each row over *reachable* queries
    (decoder bit fixed at 0, body bits free).

    Returns ``(dead, zeros, ones)``: ``dead`` (R,) — the row matches no
    reachable query; ``zeros``/``ones`` (R, used-1) — body positions whose
    input bit must be 0 / must be 1.  Two alive rows behave identically iff
    their literal sets agree; literal masks of dead rows are meaningless.
    """
    cells = np.atleast_2d(np.asarray(cells))
    dec = cells[:, 0]
    body = cells[:, 1:used]
    dead = np.isin(dec, (CELL_1, CELL_MM)) | (body == CELL_MM).any(axis=1)
    return dead, body == CELL_0, body == CELL_1


def behavior_changed_rows(
    intent_cells: np.ndarray, actual_cells: np.ndarray, used: int
) -> np.ndarray:
    """(R,) bool — rows whose faults change the match response to at least
    one reachable query (the ground truth a BIST run is scored against)."""
    di, zi, oi = row_signatures(intent_cells, used)
    da, za, oa = row_signatures(actual_cells, used)
    alive_diff = (
        ~di & ~da & ((zi != za).any(axis=1) | (oi != oa).any(axis=1))
    )
    return (di != da) | alive_diff


def march_probes(intent_row: np.ndarray, used: int) -> np.ndarray:
    """Synthesize the M0 + M1 probe set for one row's intended content.

    (used, W) uint8: row 0 is the stored word (decoder 0, CELL_1 -> 1, else
    0), rows 1.. walk a single flipped bit across the body columns.
    """
    intent_row = np.asarray(intent_row)
    w = intent_row.shape[0]
    base = np.zeros(w, np.uint8)
    base[:used] = (intent_row[:used] == CELL_1).astype(np.uint8)
    base[0] = 0                                   # decoder query bit is fixed
    probes = np.tile(base, (used, 1))
    flip = np.arange(1, used)                     # M1: walk the body bits
    probes[1 + np.arange(used - 1), flip] ^= 1
    return probes


@dataclasses.dataclass
class BistReport:
    """Per-row defect map from one self-test pass."""

    detected: np.ndarray          # (R,) bool — observed response != intent
    probes_run: int
    n_rows: int                   # LUT (non-spare) rows in the array

    @property
    def defective_rows(self) -> np.ndarray:
        return np.flatnonzero(self.detected)

    @property
    def n_defective(self) -> int:
        return int(self.detected.sum())

    def coverage(self, changed: np.ndarray) -> float:
        """Fraction of ground-truth behavior-changing rows detected
        (1.0 when nothing changed)."""
        changed = np.asarray(changed, bool)
        if not changed.any():
            return 1.0
        return float((self.detected & changed).sum() / changed.sum())

    def summary(self) -> dict:
        return {
            "rows": int(self.detected.size),
            "lut_rows": self.n_rows,
            "defective": self.n_defective,
            "defective_lut_rows": int(self.detected[: self.n_rows].sum()),
            "probes_run": self.probes_run,
        }


def _check_grids(actual_cells, intent_cells):
    actual_cells = np.asarray(actual_cells)
    intent_cells = np.asarray(intent_cells)
    if actual_cells.shape != intent_cells.shape:
        raise ValueError("actual/intent cell grids must have the same shape")
    return actual_cells, intent_cells


def _family_response(c: torch.Tensor, b: torch.Tensor):
    """A row's response to one probe family: the base word ``b`` (R, used)
    bool and, for each body column j >= 1, ``b`` with bit j flipped.

    ``ok(c, bit)``: CELL_X matches both bits, CELL_0/1 their own, CELL_MM
    neither.  With ``nbad`` the row's cells that reject ``b``, the row
    matches the base word iff ``nbad == 0``, and the flip at j iff the other
    cells all accept (``nbad - bad_j == 0``) and cell j accepts the flipped
    bit.  Returns (base (R,), flips (R, used-1)) booleans."""
    x = c == CELL_X
    ok0 = x | (c == CELL_0)
    ok1 = x | (c == CELL_1)
    bad = ~torch.where(b, ok1, ok0)
    ok_flip = torch.where(b, ok0, ok1)
    nbad = bad.sum(dim=1, keepdim=True, dtype=torch.int32)
    base = nbad[:, 0] == 0
    flips = ((nbad - bad.to(torch.int32)) == 0) & ok_flip
    return base, flips[:, 1:]


def _family_differs(intent: torch.Tensor, actual: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """(R,) bool: some probe of the family from ``b`` gets a different
    response from the intended row than from the actual row."""
    base_i, flips_i = _family_response(intent, b)
    base_a, flips_a = _family_response(actual, b)
    return (base_i != base_a) | (flips_i != flips_a).any(dim=1)


def run_bist(
    actual_cells: np.ndarray,
    intent_cells: np.ndarray,
    *,
    used: int,
    n_rows: int,
    device: DeviceLike = None,
) -> BistReport:
    """Self-test every physical row of a chip against its intended content,
    on ``device``, all rows at once.

    ``actual_cells`` is the faulty array as it responds on-chip,
    ``intent_cells`` the content the controller programmed (the ideal layout
    initially; updated by repair).  ``used = 1 + lut_width`` unmasked
    columns; ``n_rows`` LUT rows (the rest are rogue/spare rows whose intent
    is to never match).  Equal to ``run_bist_ref`` in ``detected`` and
    ``probes_run``: each row runs the intent family (M0 + M1, ``used``
    probes) and, where the readback base word differs from the intent's,
    the readback family (M2 + M3, ``used`` more).
    """
    actual_cells, intent_cells = _check_grids(actual_cells, intent_cells)
    dev = resolve_device(device)
    r = actual_cells.shape[0]
    intent = torch.from_numpy(np.ascontiguousarray(
        intent_cells[:, :used])).to(dev)
    actual = torch.from_numpy(np.ascontiguousarray(
        actual_cells[:, :used])).to(dev)
    b_int = intent == CELL_1
    b_int[:, 0] = False                       # decoder query bit is fixed
    b_act = actual == CELL_1
    b_act[:, 0] = False
    detected = _family_differs(intent, actual, b_int)
    readback = (b_act != b_int).any(dim=1)
    if bool(readback.any()):
        rows = torch.nonzero(readback).flatten()
        detected[rows] |= _family_differs(intent[rows], actual[rows],
                                          b_act[rows])
    probes_run = used * (r + int(readback.sum()))
    return BistReport(detected=detected.cpu().numpy(), probes_run=probes_run,
                      n_rows=n_rows)


def run_bist_ref(
    actual_cells: np.ndarray,
    intent_cells: np.ndarray,
    *,
    used: int,
    n_rows: int,
) -> BistReport:
    """The plain version of ``run_bist``: a loop over rows on the host that
    synthesizes each row's probes and matches them."""
    actual_cells, intent_cells = _check_grids(actual_cells, intent_cells)
    r = actual_cells.shape[0]
    detected = np.zeros(r, bool)
    probes_run = 0
    for i in range(r):
        probes = march_probes(intent_cells[i], used)         # M0 + M1
        readback = march_probes(actual_cells[i], used)       # M2 + M3
        if (readback != probes).any():
            probes = np.concatenate([probes, readback])
        probes_run += probes.shape[0]
        expect = row_match(intent_cells[i], probes, used)[0]
        got = row_match(actual_cells[i], probes, used)[0]
        detected[i] = bool((expect != got).any())
    return BistReport(detected=detected, probes_run=probes_run, n_rows=n_rows)


def bist_layout(layout: TCAMLayout, intent_cells: np.ndarray, *,
                device: DeviceLike = None) -> BistReport:
    """Convenience wrapper: self-test a layout's cells against intent."""
    return run_bist(
        layout.cells, intent_cells,
        used=1 + layout.width, n_rows=layout.n_rows, device=device,
    )
