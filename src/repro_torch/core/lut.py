"""Ternary LUT representation shared by the compiler, synthesizer and kernels.

Cell states (int8):
  CELL_0  = 0   hard 0   (2T2R {HRS, LRS})
  CELL_1  = 1   hard 1   (2T2R {LRS, HRS})
  CELL_X  = 2   don't care ({HRS, HRS}) — matches any input bit
  CELL_MM = 3   always-mismatch ({LRS, LRS}) — only arises from SA1 defects

The functional match semantics against an input *bit* b ∈ {0,1}:
  CELL_0 matches b==0; CELL_1 matches b==1; CELL_X matches both; CELL_MM none.

Bitplane form (`is0`, `is1`): mismatches(input, row) =
  Σ_bits input·is0 + (1-input)·is1 + (input + (1-input))·isMM
which is two matmuls (+ a rank-1 correction for MM cells) — the MXU-native
formulation of the bitplane match kernel (``kernels/tcam_match.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CELL_0", "CELL_1", "CELL_X", "CELL_MM", "TernaryLUT", "bitplanes"]

CELL_0 = 0
CELL_1 = 1
CELL_X = 2
CELL_MM = 3


def bitplanes(cells: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(is0, is1) uint8 planes; a CELL_MM cell sets BOTH planes (mismatch for
    either polarity), CELL_X sets neither."""
    is0 = ((cells == CELL_0) | (cells == CELL_MM)).astype(np.uint8)
    is1 = ((cells == CELL_1) | (cells == CELL_MM)).astype(np.uint8)
    return is0, is1


@dataclasses.dataclass
class TernaryLUT:
    """Encoded decision-tree LUT (pre-tiling).

    cells:        (rows, width) int8 cell states — the TCAM rule bits only
                  (no decoder column; the synthesizer adds it).
    classes:      (rows,) int32 class label per row.
    n_classes:    number of classes C; class storage uses ceil(log2 C) bits.
    feat_offsets: (features+1,) int — bit span of feature i is
                  [feat_offsets[i], feat_offsets[i+1]).
    thresholds:   list of sorted unique threshold arrays per feature (the
                  adaptive precision sets width_i = len(thresholds[i]) + 1).
    """

    cells: np.ndarray
    classes: np.ndarray
    n_classes: int
    feat_offsets: np.ndarray
    thresholds: list[np.ndarray]

    @property
    def n_rows(self) -> int:
        return int(self.cells.shape[0])

    @property
    def width(self) -> int:
        return int(self.cells.shape[1])

    @property
    def n_total(self) -> int:
        """Paper Eqn (2): total encoded cells (rows × Σ n_i)."""
        return self.n_rows * self.width

    @property
    def class_bits(self) -> int:
        return max(1, int(np.ceil(np.log2(max(self.n_classes, 2)))))

    def class_bit_matrix(self) -> np.ndarray:
        """(rows, class_bits) uint8 binary-encoded leaf classes (paper §II.B)."""
        bits = self.class_bits
        shifts = np.arange(bits - 1, -1, -1)
        return ((self.classes[:, None] >> shifts) & 1).astype(np.uint8)
