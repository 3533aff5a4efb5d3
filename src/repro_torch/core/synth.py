"""ReCAM functional synthesizer — mapping step (paper §II.C.1, Fig 3).

Splits the encoded LUT into S×S TCAM tiles:
  N_rwd = ⌈rows / S⌉ row-wise tiles (operate in parallel),
  N_cwd = ⌈(width + 1) / S⌉ column-wise tiles (operate sequentially; the +1 is
  the reserved decoder column at bit 0 of the first column division).

Padding cells are don't-cares; rogue rows (padding rows beyond the LUT) carry
a decoder-column '1' so the input's padded leading '0' forcibly mismatches
them; their class cells are populated with random valid classes (paper text).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .lut import CELL_1, CELL_X, TernaryLUT

__all__ = ["TCAMLayout", "synthesize"]


@dataclasses.dataclass
class TCAMLayout:
    """Tiled TCAM arrays + class memory.

    cells:    (N_rwd·S, N_cwd·S) int8 cell states, decoder column at [:, 0].
    classes:  (N_rwd·S,) int32 (rogue rows hold random valid classes).
    class_bits: (N_rwd·S, ceil(log2 C)) uint8 — 1T1R class storage.
    s:        tile edge S.  n_rwd, n_cwd: tile grid.  n_rows/width: LUT dims.
    """

    cells: np.ndarray
    classes: np.ndarray
    class_bits: np.ndarray
    s: int
    n_rwd: int
    n_cwd: int
    n_rows: int
    width: int
    n_classes: int

    @property
    def n_tiles(self) -> int:
        return self.n_rwd * self.n_cwd

    @property
    def n_spares(self) -> int:
        """Physical rows beyond the LUT (rogue rows) — the spare-row pool
        available to spare-row repair."""
        return int(self.cells.shape[0]) - self.n_rows

    @property
    def spare_row_indices(self) -> np.ndarray:
        return np.arange(self.n_rows, self.cells.shape[0])

    @property
    def n_cells(self) -> int:
        """Total TCAM cells across tiles (area / energy accounting)."""
        return self.n_tiles * self.s * self.s

    def pad_inputs(self, xbits: np.ndarray) -> np.ndarray:
        """(batch, width) encoded inputs -> (batch, N_cwd·S) search words:
        a leading '0' decoder bit, then the code, then zero padding (the
        padded LUT cells are don't-care/masked so the pad value is moot)."""
        b = xbits.shape[0]
        out = np.zeros((b, self.n_cwd * self.s), dtype=np.uint8)
        out[:, 1 : 1 + self.width] = xbits
        return out

    def area_m2(self, hw=None) -> float:
        """Eqn 11 with the calibrated 16nm cells."""
        from .energy import DEFAULT_HW

        hw = hw or DEFAULT_HW
        s = self.s
        tcam = self.n_tiles * (
            s * s * hw.a_2t2r + s * (hw.a_sa + hw.a_dff + hw.a_sp)
        )
        cbits = max(1, math.ceil(math.log2(max(self.n_classes, 2))))
        cls = s * cbits * (hw.a_1t1r + hw.a_sa2)
        return tcam + cls


def synthesize(
    lut: TernaryLUT, s: int, *, seed: int = 0, spare_rows: int = 0
) -> TCAMLayout:
    """Map the encoded LUT into S×S tiles with decoder column + rogue rows.

    ``spare_rows`` guarantees at least that many rogue rows beyond the LUT
    (adding row-wise tiles as needed) so the reliability layer has a spare
    pool to remap defective rows onto; the natural tile padding already
    provides ``n_rwd·s - rows`` spares for free.
    """
    if spare_rows < 0:
        raise ValueError("spare_rows must be >= 0")
    rows, width = lut.n_rows, lut.width
    n_rwd = max(1, math.ceil((rows + spare_rows) / s))
    n_cwd = max(1, math.ceil((width + 1) / s))
    total_rows, total_cols = n_rwd * s, n_cwd * s

    cells = np.full((total_rows, total_cols), CELL_X, dtype=np.int8)
    cells[:rows, 1 : 1 + width] = lut.cells
    # decoder column: LUT rows store '0' (matches the padded input '0');
    # rogue rows store '1' -> forced mismatch.
    cells[:rows, 0] = 0
    cells[rows:, 0] = CELL_1

    rng = np.random.default_rng(seed)
    classes = np.empty(total_rows, dtype=np.int32)
    classes[:rows] = lut.classes
    classes[rows:] = rng.integers(0, lut.n_classes, size=total_rows - rows)

    cbits = max(1, math.ceil(math.log2(max(lut.n_classes, 2))))
    shifts = np.arange(cbits - 1, -1, -1)
    class_bits = ((classes[:, None] >> shifts) & 1).astype(np.uint8)

    return TCAMLayout(
        cells=cells,
        classes=classes,
        class_bits=class_bits,
        s=s,
        n_rwd=n_rwd,
        n_cwd=n_cwd,
        n_rows=rows,
        width=width,
        n_classes=lut.n_classes,
    )
