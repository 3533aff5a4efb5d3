"""LifecycleManager: registry -> delta plan -> shadow -> promote, end to end.

The manager is the orchestration layer tying the lifecycle pieces together
for one serving deployment:

* it resolves model versions through a ``ModelRegistry``;
* every (re)programming pass is planned at write-pulse resolution
  (``plan_full`` for the initial deploy, ``plan_delta`` for updates),
  optionally wear-leveled (``wear_level_rows``), and recorded into one
  ``WearTracker`` — the chip's cumulative endurance ledger;
* staging/promotion/rollback delegate to the server's shadow slot
  (``TCAMServer.stage/promote/rollback``).

The manager never imports ``serve`` — it receives an already
constructed server object (duck-typed: ``live_intent``, ``live_layout``,
``stage``, ``promote``, ``rollback``, ``staged``), so ``lifecycle``
stays numpy-only and eagerly importable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.energy import DEFAULT_HW, HardwareParams
from .delta import WritePlan, plan_delta, plan_full
from .registry import ModelRegistry
from .wear import WearTracker, wear_level_rows

__all__ = ["LifecycleManager"]


class LifecycleManager:
    """Drive one server's model lifecycle against a versioned registry.

    >>> mgr = LifecycleManager(registry, server, live_version=v1.version_id)
    >>> plan = mgr.stage(v2.version_id, mirror_fraction=0.5)
    >>> ... serve traffic; the shadow slot mirrors it ...
    >>> report = mgr.promote(max_disagreement=0.05)
    """

    def __init__(
        self,
        registry: ModelRegistry,
        server=None,
        *,
        live_version: Optional[str] = None,
        hw: HardwareParams = DEFAULT_HW,
        wear: Optional[WearTracker] = None,
    ) -> None:
        self.registry = registry
        self.server = server
        self.hw = hw
        self.wear = wear if wear is not None else WearTracker(hw=hw)
        self.live_version: Optional[str] = None
        self.candidate_version: Optional[str] = None
        self._prev_version: Optional[str] = None
        self.plans: list[WritePlan] = []
        if live_version is not None:
            self.attach(server, live_version)

    # -- binding ------------------------------------------------------------
    def attach(self, server, live_version: str) -> WritePlan:
        """Bind a server already serving ``live_version`` and account the
        initial full programming pass (erased array -> v1) in the wear
        ledger."""
        if server is None:
            raise ValueError("attach requires a server instance")
        v = self.registry.get(live_version)
        if v.kind != "tree":
            raise NotImplementedError(
                "LifecycleManager drives single-model servers; forests are "
                "planned bank-by-bank via plan_forest_delta"
            )
        self.server = server
        self.live_version = live_version
        lay = server.live_layout
        plan = plan_full(
            np.zeros((0, 0), np.int8), server.live_intent,
            new_class_bits=lay.class_bits,
        )
        self.wear.record(plan)
        self.plans.append(plan)
        return plan

    def _require_server(self):
        if self.server is None:
            raise RuntimeError("no server attached; call attach() first")
        return self.server

    # -- the update path ----------------------------------------------------
    def stage(
        self,
        version_id: str,
        *,
        mirror_fraction: float = 0.25,
        wear_level: bool = False,
        forbidden: Sequence[int] = (),
        alpha: float = 1.0,
        full: bool = False,
    ) -> WritePlan:
        """Plan the reprogramming pass live -> ``version_id``, record its
        wear, and stage the candidate into the server's shadow slot.

        ``wear_level=True`` re-places the candidate's rows first
        (``wear_level_rows`` against the live intent and the accumulated
        wear; ``forbidden`` composes with ``RepairReport.blocked_rows``).
        ``full=True`` plans a naive erase-then-program pass instead of the
        delta — the benchmark uses both to report the saving."""
        server = self._require_server()
        candidate = self.registry.load(version_id)
        if hasattr(candidate, "banks"):
            raise NotImplementedError(
                "staging a forest is not supported; see plan_forest_delta"
            )
        old_cells = server.live_intent
        old_bits = server.live_layout.class_bits
        if wear_level:
            remap = wear_level_rows(
                candidate.layout, old_cells, self.wear,
                forbidden=forbidden, alpha=alpha,
            )
            candidate = dataclasses.replace(candidate, layout=remap.layout)
        planner = plan_full if full else plan_delta
        plan = planner(
            old_cells, candidate.layout.cells,
            old_class_bits=old_bits,
            new_class_bits=candidate.layout.class_bits,
        )
        server.stage(candidate, mirror_fraction=mirror_fraction)
        # record only after stage() accepted the candidate — a rejected
        # stage (feature mismatch, slot occupied) programs nothing
        self.wear.record(plan)
        self.plans.append(plan)
        self.candidate_version = version_id
        return plan

    def promote(self, **gates):
        """Evaluate the server's promotion gates; on success the candidate
        version becomes the live version (previous stashed for rollback)."""
        server = self._require_server()
        report = server.promote(**gates)
        if report.promoted:
            self._prev_version = self.live_version
            self.live_version = self.candidate_version
            self.candidate_version = None
        elif not report.staged:
            self.candidate_version = None     # gate rejected: unstaged
        return report

    def rollback(self) -> str:
        """Mirror the server's rollback: unstage the candidate, or revert
        the last promotion (restoring the previous live version)."""
        server = self._require_server()
        action = server.rollback()
        if action == "unstaged":
            self.candidate_version = None
        else:
            self.live_version = self._prev_version
            self._prev_version = None
        return action

    # -- introspection -------------------------------------------------------
    def status(self) -> dict:
        return {
            "live_version": self.live_version,
            "candidate_version": self.candidate_version,
            "staged": (self.server.staged
                       if self.server is not None else False),
            "plans_executed": len(self.plans),
            "last_plan": (self.plans[-1].summary() if self.plans else None),
            "last_plan_figures": (
                self.plans[-1].figures(self.hw) if self.plans else None
            ),
            "wear": self.wear.snapshot(),
        }
