"""Golden-vector canary probes.

A canary is a tiny fixed query set with *known-good* answers, replayed
periodically through the production compute path.  Golden vectors are
synthesized from the ideal layout (one matching word per LUT row, don't-care
positions filled randomly) and labelled by evaluating the *ideal* chip — no
dataset required at serving time.

The port's server builds its canary at construction, because its rng draws
are part of the serving contract (a server seeded like the JAX package's
draws the same per-batch noise).  Replaying it periodically, with the
circuit breaker that acts on it, belongs to the reliability slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.lut import CELL_X
from ..core.synth import TCAMLayout
from .bist import march_probes, row_match

__all__ = ["CanaryProbe", "make_canary"]


@dataclasses.dataclass(frozen=True)
class CanaryProbe:
    """Golden vectors at the search-word level: (n, W) padded words plus the
    ideal chip's predictions for them."""

    words: np.ndarray
    expected: np.ndarray

    def __len__(self) -> int:
        return int(self.words.shape[0])

    def accuracy(self, predictions: np.ndarray) -> float:
        return float(
            (np.asarray(predictions) == self.expected).mean()
        )


def make_canary(
    layout: TCAMLayout,
    n: int,
    rng: np.random.Generator,
) -> CanaryProbe:
    """Synthesize golden vectors from an ideal layout.

    Each vector is a LUT row's matching word with its don't-care positions
    filled from ``rng`` (so the canary also exercises bits the row ignores);
    expected labels come from evaluating the ideal layout itself, so a
    canary miss always means the serving chip diverged from the ideal chip.
    """
    used = 1 + layout.width
    w = layout.cells.shape[1]
    rows = rng.choice(
        np.arange(layout.n_rows), size=n, replace=n > layout.n_rows
    )
    words = np.zeros((n, w), np.uint8)
    for i, r in enumerate(rows):
        base = march_probes(layout.cells[r], used)[0]
        xmask = layout.cells[r, 1:used] == CELL_X     # don't-care positions
        fill = rng.integers(0, 2, size=int(xmask.sum())).astype(np.uint8)
        base[1:used][xmask] = fill
        words[i] = base
    m = row_match(layout.cells, words, used)          # (R, n)
    hit = m.any(axis=0)
    first = np.argmax(m, axis=0)
    expected = np.where(
        hit, layout.classes[first], 0
    ).astype(np.int32)
    return CanaryProbe(words=words, expected=expected)
