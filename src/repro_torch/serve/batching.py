"""Adaptive batch formation for the TCAM serving engine.

Two pure-logic pieces (no threads, injected clock — unit-testable):

* ``BucketPolicy`` — the fixed ladder of padded batch shapes.  Every batch is
  zero-padded up to the smallest bucket that fits, so the build cache
  sees a bounded set of input shapes: at most ``len(buckets)`` builds per
  (engine, layout), no matter what request sizes arrive.
* ``AdaptiveBatcher`` — a FIFO of pending requests with the classic serving
  flush rule: emit a batch as soon as ``max_batch`` requests are waiting
  (throughput bound) or the *oldest* pending request has waited
  ``max_delay_s`` (tail-latency bound).  With a per-request ``timeout_s``
  the batcher is also *expiry-aware*: ``deadline()`` wakes the worker at
  the earlier of flush-due and first-expiry, and ``pop_expired`` removes
  dead requests so they are failed promptly instead of squatting on
  bounded-queue capacity until the next flush.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Optional

__all__ = ["BucketPolicy", "AdaptiveBatcher"]


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Power-of-two padding buckets ``min_bucket, 2·min_bucket, ..`` capped
    (and always terminated) at ``max_batch``."""

    max_batch: int = 256
    min_bucket: int = 8

    def __post_init__(self) -> None:
        if self.max_batch < 1 or self.min_bucket < 1:
            raise ValueError("max_batch and min_bucket must be >= 1")
        if self.min_bucket > self.max_batch:
            raise ValueError("min_bucket must be <= max_batch")

    @property
    def buckets(self) -> tuple[int, ...]:
        out = []
        b = self.min_bucket
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return tuple(out)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n must be <= max_batch)."""
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"batch size {n} outside [1, {self.max_batch}]")
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch  # unreachable; keeps mypy honest


@dataclasses.dataclass
class _Pending:
    item: Any
    t_enqueue: float


class AdaptiveBatcher:
    """FIFO with flush-on-max-batch-or-deadline semantics, optionally aware
    of a per-request queue timeout (``timeout_s``)."""

    def __init__(self, max_batch: int, max_delay_s: float,
                 timeout_s: Optional[float] = None) -> None:
        if max_delay_s < 0:
            raise ValueError("max_delay_s must be >= 0")
        if timeout_s is not None and timeout_s < 0:
            raise ValueError("timeout_s must be >= 0")
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.timeout_s = timeout_s
        self._q: Deque[_Pending] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def add(self, item: Any, now: float) -> None:
        self._q.append(_Pending(item, now))

    def _expired(self, p: _Pending, now: float) -> bool:
        return (self.timeout_s is not None
                and now > p.t_enqueue + self.timeout_s)

    def deadline(self) -> Optional[float]:
        """Wall time at which the worker must next wake: the oldest pending
        request's flush deadline, or its expiry if that comes first.
        None when the queue is empty."""
        if not self._q:
            return None
        dl = self._q[0].t_enqueue + self.max_delay_s
        if self.timeout_s is not None:
            dl = min(dl, self._q[0].t_enqueue + self.timeout_s)
        return dl

    def flush_due(self, now: float) -> bool:
        """True when a batch should be emitted: ``max_batch`` waiting or the
        oldest request has waited ``max_delay_s``."""
        if not self._q:
            return False
        return (len(self._q) >= self.max_batch
                or now >= self._q[0].t_enqueue + self.max_delay_s)

    def ready(self, now: float) -> bool:
        """True when the worker has something to do — flush a batch *or*
        fail expired requests."""
        if not self._q:
            return False
        return self.flush_due(now) or self._expired(self._q[0], now)

    def pop_expired(self, now: float) -> list[_Pending]:
        """Remove and return requests whose queue timeout has passed.
        FIFO order makes enqueue times monotone, so expired requests are
        always a prefix of the queue."""
        out: list[_Pending] = []
        while self._q and self._expired(self._q[0], now):
            out.append(self._q.popleft())
        return out

    def pop_batch(self) -> list[_Pending]:
        """Pop up to ``max_batch`` oldest pending requests (possibly fewer —
        a deadline flush takes whatever is waiting)."""
        n = min(len(self._q), self.max_batch)
        return [self._q.popleft() for _ in range(n)]
