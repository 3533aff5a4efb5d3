"""March-test helpers the golden-vector canary is built from.

``row_match`` evaluates search words against rows of cells the way a healthy
chip does; ``march_probes`` synthesizes a row's stored word (M0) and its
walking-bit neighbours (M1).  The self-test that uses them in full (BIST,
spare-row repair) belongs to the port's reliability slice.
"""
from __future__ import annotations

import numpy as np

from ..core.lut import CELL_0, CELL_1, CELL_X

__all__ = ["march_probes", "row_match"]


def row_match(cells: np.ndarray, words: np.ndarray, used: int) -> np.ndarray:
    """Evaluate search words against rows of cells; (R, P) or (P,) booleans.

    A row survives iff every unmasked cell (columns ``[0, used)``) matches:
    CELL_X matches both bits, CELL_0/1 match their bit, CELL_MM matches
    neither.  Columns beyond ``used`` are masked (OFF-OFF) and ignored —
    identical to the oracle's final survive with kmax=0.
    """
    cells = np.atleast_2d(np.asarray(cells))[:, :used]       # (R, used)
    words = np.atleast_2d(np.asarray(words))[:, :used]       # (P, used)
    c = cells[:, None, :]                                    # (R, 1, used)
    w = words[None, :, :]                                    # (1, P, used)
    ok = ((c == CELL_X) | ((c == CELL_0) & (w == 0))
          | ((c == CELL_1) & (w == 1)))
    return ok.all(axis=2)                                    # (R, P)


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
