"""Fault-tolerant training loop.

Production posture (DESIGN.md §5): at 1000+ nodes, *something* fails every
few hours.  The loop provides:

  * **checkpoint/restart** — periodic atomic checkpoints; on step failure the
    loop restores the latest valid checkpoint and replays (the data pipeline
    is a pure function of (seed, step), so replay is exact);
  * **bounded retries** — ``max_retries`` consecutive failures abort with the
    last exception (a crash-looping job must page a human);
  * **straggler mitigation** — per-step wall times feed a rolling median; a
    step slower than ``straggler_factor``x the median is logged and counted.
    On real pods the mitigation hook triggers re-compilation onto a spare
    slice (elastic re-mesh via ``checkpoint.restore_resharded``); here the
    hook is observable + testable;
  * **preemption handling** — SIGTERM sets a flag; the loop checkpoints and
    exits cleanly at the next step boundary.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np

from ..checkpoint import CheckpointManager

__all__ = ["StragglerMonitor", "FaultTolerantLoop"]


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 2.5
    window: int = 32
    times: list = dataclasses.field(default_factory=list)
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        """Record a step time; True if it was a straggler step."""
        is_straggler = False
        if len(self.times) >= 8:
            med = float(np.median(self.times[-self.window:]))
            is_straggler = dt > self.factor * med
        self.times.append(dt)
        if is_straggler:
            self.stragglers += 1
        return is_straggler


class FaultTolerantLoop:
    def __init__(
        self,
        step_fn: Callable,                  # (state, batch) -> (state, metrics)
        batch_fn: Callable,                 # step -> batch
        ckpt: CheckpointManager,
        *,
        ckpt_every: int = 100,
        max_retries: int = 3,
        straggler: Optional[StragglerMonitor] = None,
        on_straggler: Optional[Callable] = None,
        install_sigterm: bool = False,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.straggler = straggler or StragglerMonitor()
        self.on_straggler = on_straggler
        self.preempted = False
        self.retries = 0
        if install_sigterm:
            signal.signal(signal.SIGTERM, self._handle_sigterm)

    def _handle_sigterm(self, signum, frame):
        self.preempted = True

    def run(self, state, start_step: int, n_steps: int,
            *, log_every: int = 10, log=print):
        step = start_step
        history = []
        while step < start_step + n_steps:
            if self.preempted:
                self.ckpt.save(step, state)
                log(f"[preempt] checkpointed at step {step}, exiting")
                break
            try:
                t0 = time.perf_counter()
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                loss = metrics.get("loss")
                if loss is not None:
                    lv = float(loss)
                    if not np.isfinite(lv):
                        raise FloatingPointError(
                            f"non-finite loss {lv} at step {step}")
                dt = time.perf_counter() - t0
                if self.straggler.observe(dt) and self.on_straggler:
                    self.on_straggler(step, dt)
                history.append(
                    {k: float(v) for k, v in metrics.items()} | {"step": step})
                if log_every and step % log_every == 0:
                    log(f"step {step}: " + " ".join(
                        f"{k}={float(v):.4g}" for k, v in metrics.items()))
                self.retries = 0
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except (FloatingPointError, RuntimeError) as e:  # node failure
                self.retries += 1
                log(f"[fault] step {step} failed ({e}); "
                    f"retry {self.retries}/{self.max_retries}")
                if self.retries > self.max_retries:
                    raise
                restored = self.ckpt.restore(state)
                if restored is not None:
                    state, step = restored
                    log(f"[fault] restored checkpoint at step {step}")
        return state, step, history
