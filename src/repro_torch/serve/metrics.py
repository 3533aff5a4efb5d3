"""Serving metrics: counters, latency percentiles, and the modelled-hardware
figures of merit (nJ/decision, M decisions/s) the paper reports.

``LatencyStats`` keeps a bounded ring of samples; percentiles are computed on
demand.  ``ServeMetrics`` aggregates everything a load test needs into one
``snapshot()`` dict (JSON-serializable — the serve benchmark dumps it as-is).
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["LatencyStats", "ServeMetrics"]


class LatencyStats:
    """Bounded-reservoir latency recorder (seconds in, percentiles out)."""

    def __init__(self, capacity: int = 16384) -> None:
        self._buf = np.zeros(capacity, np.float64)
        self._n = 0          # total recorded (may exceed capacity)
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._n % self._buf.size] = seconds
            self._n += 1

    def record_many(self, seconds: np.ndarray) -> None:
        for s in np.asarray(seconds, np.float64).ravel():
            self.record(float(s))

    @property
    def count(self) -> int:
        return self._n

    def _samples(self) -> np.ndarray:
        with self._lock:
            return self._buf[: min(self._n, self._buf.size)].copy()

    def percentile(self, q: float) -> float:
        s = self._samples()
        return float(np.percentile(s, q)) if s.size else float("nan")

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def mean(self) -> float:
        s = self._samples()
        return float(s.mean()) if s.size else float("nan")

    def summary_ms(self) -> dict[str, float]:
        return {
            "p50_ms": self.p50 * 1e3,
            "p99_ms": self.p99 * 1e3,
            "mean_ms": self.mean * 1e3,
            "count": float(self.count),
        }


class ServeMetrics:
    """Aggregated serving counters + latency stats.

    Latency is split the way serving systems report it: *queue* (enqueue ->
    batch formation) and *compute* (batch dispatch -> device results ready);
    a request's end-to-end latency is queue + compute of its batch.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests_enqueued = 0
        self.requests_served = 0
        self.batches = 0
        self.deadline_flushes = 0     # batches emitted by timeout, not by fill
        self.padded_slots = 0         # Σ (bucket - actual batch size)
        self.engine_fallbacks = 0     # illegal engine requests downgraded
        self.energy_j = 0.0           # Σ modelled energy of served decisions
        self.active_evals = 0         # Σ modelled active row-division evals
        # -- reliability / protection counters --------------------------------
        self.shed = 0                 # requests rejected at admission (queue full)
        self.deadline_exceeded = 0    # requests expired in queue before dispatch
        self.retries = 0              # transient compute failures retried
        self.compute_failures = 0     # batches failed after retry budget
        self.canary_runs = 0
        self.canary_failures = 0      # canary accuracy below threshold
        self.breaker_trips = 0
        self.repairs = 0              # repair attempts (BIST + spare remap)
        self.rows_repaired = 0
        self.last_canary_acc = float("nan")
        # -- degradation (drift scrub / refresh) -------------------------------
        self.scrub_passes = 0         # maintenance passes executed
        self.rows_scrubbed = 0        # Σ rows refreshed across passes
        self.scrub_energy_j = 0.0     # Σ modelled refresh write energy
        self.scrub_pulses = 0         # Σ refresh program pulses (endurance)
        # -- lifecycle (shadow deployment / promotion) -------------------------
        self.stages = 0               # candidates staged into the shadow slot
        self.shadow_batches = 0       # live batches mirrored to the candidate
        self.shadow_requests = 0      # requests the candidate shadow-served
        self.shadow_disagreements = 0  # candidate != live predictions
        self.promotions = 0           # successful atomic swaps
        self.promotion_failures = 0   # promote() gates rejected the candidate
        self.rollbacks = 0            # explicit rollback() calls honored
        self.queue = LatencyStats()
        self.compute = LatencyStats()
        self.total = LatencyStats()

    def on_enqueue(self, n: int = 1) -> None:
        with self._lock:
            self.requests_enqueued += n

    def on_shed(self, n: int = 1) -> None:
        with self._lock:
            self.shed += n

    def on_deadline_exceeded(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_exceeded += n

    def on_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def on_compute_failure(self) -> None:
        with self._lock:
            self.compute_failures += 1

    def on_canary(self, ok: bool, accuracy: float) -> None:
        with self._lock:
            self.canary_runs += 1
            self.canary_failures += int(not ok)
            self.last_canary_acc = accuracy

    def on_trip(self) -> None:
        with self._lock:
            self.breaker_trips += 1

    def on_repair(self, rows: int) -> None:
        with self._lock:
            self.repairs += 1
            self.rows_repaired += rows

    def on_scrub(self, rows: int, energy_j: float, pulses: int) -> None:
        with self._lock:
            self.scrub_passes += 1
            self.rows_scrubbed += rows
            self.scrub_energy_j += energy_j
            self.scrub_pulses += pulses

    def on_stage(self) -> None:
        with self._lock:
            self.stages += 1

    def on_shadow(self, n: int, disagreements: int) -> None:
        with self._lock:
            self.shadow_batches += 1
            self.shadow_requests += n
            self.shadow_disagreements += disagreements

    def on_promotion(self, ok: bool) -> None:
        with self._lock:
            self.promotions += int(ok)
            self.promotion_failures += int(not ok)

    def on_rollback(self) -> None:
        with self._lock:
            self.rollbacks += 1

    def on_batch(
        self,
        n: int,
        bucket: int,
        *,
        deadline_flush: bool,
        energy_j: float,
        active_evals: int,
    ) -> None:
        with self._lock:
            self.requests_served += n
            self.batches += 1
            self.deadline_flushes += int(deadline_flush)
            self.padded_slots += bucket - n
            self.energy_j += energy_j
            self.active_evals += active_evals

    def on_fallback(self) -> None:
        with self._lock:
            self.engine_fallbacks += 1

    def snapshot(self, **extra: float) -> dict:
        """One JSON-ready dict: counters, latency summaries, and whatever
        engine-level extras (hw model numbers, cache stats) are passed in."""
        with self._lock:
            served = self.requests_served
            out = {
                "requests_enqueued": self.requests_enqueued,
                "requests_served": served,
                "batches": self.batches,
                "deadline_flushes": self.deadline_flushes,
                "padded_slots": self.padded_slots,
                "engine_fallbacks": self.engine_fallbacks,
                "mean_batch_fill": (
                    served / max(1, served + self.padded_slots)
                ),
                "modelled_nj_per_dec": (
                    self.energy_j / served * 1e9 if served else float("nan")
                ),
                "active_evals": self.active_evals,
                "reliability": {
                    "shed": self.shed,
                    "deadline_exceeded": self.deadline_exceeded,
                    "retries": self.retries,
                    "compute_failures": self.compute_failures,
                    "canary_runs": self.canary_runs,
                    "canary_failures": self.canary_failures,
                    "breaker_trips": self.breaker_trips,
                    "repairs": self.repairs,
                    "rows_repaired": self.rows_repaired,
                    "last_canary_acc": self.last_canary_acc,
                },
                "degradation": {
                    "scrub_passes": self.scrub_passes,
                    "rows_scrubbed": self.rows_scrubbed,
                    "scrub_energy_j": self.scrub_energy_j,
                    "scrub_pulses": self.scrub_pulses,
                },
                "lifecycle": {
                    "stages": self.stages,
                    "shadow_batches": self.shadow_batches,
                    "shadow_requests": self.shadow_requests,
                    "shadow_disagreements": self.shadow_disagreements,
                    "shadow_disagreement_rate": (
                        self.shadow_disagreements / self.shadow_requests
                        if self.shadow_requests else 0.0
                    ),
                    "promotions": self.promotions,
                    "promotion_failures": self.promotion_failures,
                    "rollbacks": self.rollbacks,
                },
            }
        out["queue_latency"] = self.queue.summary_ms()
        out["compute_latency"] = self.compute.summary_ms()
        out["total_latency"] = self.total.summary_ms()
        out.update(extra)
        return out
