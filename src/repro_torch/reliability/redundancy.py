"""N-modular redundancy: majority voting across independently-faulty chips.

``ReplicatedServer`` runs k ``TCAMServer`` instances over the same compiled
model, each with an *independently sampled* chip (its own stuck-at mask and
SA offsets — child generators spawned from one root rng).  Every request
fans out to all k replicas; the result is the majority vote over the replica
predictions, with per-request disagreement surfaced and aggregated.

Independent defects rarely corrupt the same rule on multiple chips, so
majority voting recovers most single-chip errors — the classic TMR argument,
here measurable: ``metrics()['disagreement_rate']`` is a live estimate of
how often redundancy is earning its keep.

Every replica runs on ``device`` (the card unless the caller asks for the
CPU), each with its own device operands.

Replica failures degrade gracefully: a request's vote is taken over the
replicas that answered; only if *all* replicas fail does the fan-out future
fail (with the first replica's exception).
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from ..core.compiler import CompiledDT
from ..core.nonideal import IDEAL, NonIdealSpec
from ..device import DeviceLike

__all__ = ["VotedResult", "ReplicatedServer", "majority_vote"]


def majority_vote(votes: Sequence[int]) -> int:
    """Plurality winner; ties broken toward the smallest class id."""
    counts = np.bincount(np.asarray(votes, dtype=np.int64))
    return int(np.argmax(counts))


@dataclasses.dataclass(frozen=True)
class VotedResult:
    """Fan-out outcome: the voted decision plus per-replica detail."""

    prediction: int
    votes: tuple              # per-replica predicted class (None = failed)
    n_replicas: int
    n_answered: int
    n_agree: int              # replicas that voted with the majority
    results: tuple            # per-replica RequestResult (None = failed)

    @property
    def unanimous(self) -> bool:
        return self.n_agree == self.n_answered

    @property
    def disagreement(self) -> bool:
        return self.n_answered > 0 and not self.unanimous


class ReplicatedServer:
    """k-modular-redundant front door over ``TCAMServer`` replicas.

    >>> rs = ReplicatedServer(model.compiled, k=3,      # on the GPU
    ...                       nonideal=NonIdealSpec(p_sa0=0.02, p_sa1=0.02))
    >>> rs.submit(x).result().prediction       # majority of 3 chips
    >>> rs.metrics()["disagreement_rate"]
    >>> rs.close()
    """

    def __init__(
        self,
        compiled: CompiledDT,
        k: int = 3,
        *,
        nonideal: NonIdealSpec = IDEAL,
        rng: Optional[np.random.Generator] = None,
        device: DeviceLike = None,
        **server_kwargs,
    ) -> None:
        if k < 1:
            raise ValueError("k must be >= 1")
        from ..serve.engine import TCAMServer  # lazy: avoid import cycle

        rng = rng if rng is not None else np.random.default_rng(0)
        self.replicas = [
            TCAMServer(compiled, nonideal=nonideal, rng=child, device=device,
                       **server_kwargs)
            for child in rng.spawn(k)
        ]
        self._lock = threading.Lock()
        self.requests = 0
        self.disagreements = 0
        self.replica_failures = 0
        self.agree_sum = 0
        self.answered_sum = 0

    @property
    def k(self) -> int:
        return len(self.replicas)

    # -- request fan-out ---------------------------------------------------
    def submit(self, x: np.ndarray) -> Future:
        out: Future = Future()
        parts = [r.submit(x) for r in self.replicas]
        pending = [len(parts)]
        plock = threading.Lock()

        def on_done(_f) -> None:
            with plock:
                pending[0] -= 1
                if pending[0]:
                    return
            self._combine(parts, out)

        for f in parts:
            f.add_done_callback(on_done)
        return out

    def _combine(self, parts: list, out: Future) -> None:
        results = [None if f.exception() is not None else f.result()
                   for f in parts]
        votes = [r.prediction if r is not None else None for r in results]
        answered = [v for v in votes if v is not None]
        n_failed = len(votes) - len(answered)
        with self._lock:
            self.requests += 1
            self.replica_failures += n_failed
        if not answered:
            out.set_exception(next(f.exception() for f in parts
                                   if f.exception() is not None))
            return
        winner = majority_vote(answered)
        n_agree = sum(v == winner for v in answered)
        with self._lock:
            self.answered_sum += len(answered)
            self.agree_sum += n_agree
            if n_agree != len(answered):
                self.disagreements += 1
        out.set_result(VotedResult(
            prediction=winner,
            votes=tuple(votes),
            n_replicas=len(votes),
            n_answered=len(answered),
            n_agree=n_agree,
            results=tuple(results),
        ))

    def submit_many(self, X: np.ndarray) -> list[Future]:
        return [self.submit(row) for row in np.asarray(X)]

    def serve(self, X: np.ndarray) -> list[VotedResult]:
        futs = self.submit_many(X)
        self.drain()
        return [f.result() for f in futs]

    # -- lifecycle & metrics ----------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> None:
        for r in self.replicas:
            r.drain(timeout)

    def metrics(self) -> dict:
        with self._lock:
            reqs = self.requests
            out = {
                "k": self.k,
                "requests": reqs,
                "disagreements": self.disagreements,
                "disagreement_rate": (
                    self.disagreements / reqs if reqs else 0.0
                ),
                "mean_agreement": (
                    self.agree_sum / self.answered_sum
                    if self.answered_sum else float("nan")
                ),
                "replica_failures": self.replica_failures,
            }
        out["replicas"] = [r.metrics() for r in self.replicas]
        out["health"] = [r.health() for r in self.replicas]
        return out

    def close(self) -> None:
        for r in self.replicas:
            r.close()

    def __enter__(self) -> "ReplicatedServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
