"""Golden-vector canary probes and the serving circuit breaker.

A canary is a tiny fixed query set with *known-good* answers, replayed
periodically through the production compute path.  Golden vectors are
synthesized from the ideal layout (one matching word per LUT row, don't-care
positions filled randomly) and labelled by evaluating the *ideal* chip — no
dataset required at serving time.

``CircuitBreaker`` tracks the chip-health state machine the server drives:

    HEALTHY --canary below threshold--> DEGRADED
    DEGRADED --drift scrub + refresh + canary re-vote ok--> REPAIRED
    DEGRADED --BIST + spare-row repair + canary re-vote ok--> REPAIRED
    DEGRADED/REPAIRED --repair insufficient, 'ref' engine canary ok--> FALLBACK
    otherwise --> FAILED   (still serving, loudly degraded)
    REPAIRED --routine canary re-pass--> HEALTHY   (re-enters steady state)

The breaker never opens the request path — a degraded chip keeps answering
(the paper's whole point is graceful accuracy degradation); the state is
surfaced through ``TCAMServer.health()`` and the metrics snapshot so
operators and the ReplicatedServer can react.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.lut import CELL_X
from ..core.synth import TCAMLayout
from .bist import march_probes, row_match

__all__ = ["BreakerState", "CanaryProbe", "CircuitBreaker", "make_canary"]


class BreakerState:
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    REPAIRED = "repaired"
    FALLBACK = "fallback"
    FAILED = "failed"


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


@dataclasses.dataclass
class CircuitBreaker:
    """Chip-health state machine fed by canary accuracies."""

    threshold: float = 0.9
    state: str = BreakerState.HEALTHY
    trips: int = 0
    last_accuracy: float = float("nan")
    recovery: Optional[str] = None     # 'scrub' | 'repair' | 'fallback_ref'

    def observe(self, accuracy: float) -> bool:
        """Record a routine canary run; True iff the breaker trips (healthy
        or recovered state and accuracy below threshold)."""
        self.last_accuracy = accuracy
        if accuracy >= self.threshold:
            if self.state in (BreakerState.DEGRADED, BreakerState.FAILED,
                              BreakerState.REPAIRED):
                # DEGRADED/FAILED: chip spontaneously back above threshold;
                # REPAIRED: a routine canary re-passed after recovery, so the
                # chip re-enters steady state.  FALLBACK stays sticky — its
                # canaries pass *on the fallback engine*, which says nothing
                # about the primary path.
                self.state = BreakerState.HEALTHY
            return False
        if self.state in (BreakerState.HEALTHY, BreakerState.REPAIRED,
                          BreakerState.FALLBACK):
            self.state = BreakerState.DEGRADED
            self.trips += 1
            return True
        return self.state == BreakerState.DEGRADED

    def recovered(self, how: str, accuracy: float) -> None:
        """A recovery rung re-passed the canary: 'scrub' (drift refresh) and
        'repair' (spare-row remap) restore full-fidelity serving (REPAIRED);
        anything else is a degraded-but-serving fallback (FALLBACK)."""
        self.last_accuracy = accuracy
        self.recovery = how
        self.state = (
            BreakerState.REPAIRED if how in ("scrub", "repair")
            else BreakerState.FALLBACK
        )

    def failed(self, accuracy: float) -> None:
        self.last_accuracy = accuracy
        self.state = BreakerState.FAILED

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "trips": self.trips,
            "threshold": self.threshold,
            "last_accuracy": self.last_accuracy,
            "recovery": self.recovery,
        }
