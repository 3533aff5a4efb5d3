"""Model lifecycle: versioned registry, endurance-aware delta reprogramming,
and zero-downtime promotion.

A TCAM deployment is not compiled once — models retrain, chips wear, and
updates must land without dropping a request.  This package is that half of
the reproduction:

  registry.py — ``ModelRegistry``: content-hashed, lineage-tracked storage of
                compiled models (``.npz`` blobs + JSON index, round-trip
                exact)
  delta.py    — ``plan_delta`` / ``plan_full`` / ``plan_forest_delta``: cell-
                wise layout diffs at write-pulse (SET/RESET per resistive
                element) resolution
  wear.py     — ``WearTracker`` (per-cell endurance ledger) and
                ``wear_level_rows`` (row placement that minimises pulses and
                spreads wear; composes with ``RepairReport.blocked_rows``)
  manager.py  — ``LifecycleManager``: registry -> plan -> shadow -> promote
                against a ``TCAMServer`` (received, never imported — this
                package stays numpy-only)

The serving side (shadow slot, promotion gates, atomic swap) lives on
``serve.TCAMServer``: ``stage()`` / ``promote()`` / ``rollback()``.
"""
from .delta import (
    WritePlan,
    cell_planes,
    plan_delta,
    plan_forest_delta,
    plan_full,
)
from .manager import LifecycleManager
from .registry import ModelRegistry, ModelVersion, content_hash
from .wear import RemapResult, WearTracker, wear_level_rows

__all__ = [
    "WritePlan", "cell_planes", "plan_delta", "plan_full",
    "plan_forest_delta",
    "ModelRegistry", "ModelVersion", "content_hash",
    "WearTracker", "RemapResult", "wear_level_rows",
    "LifecycleManager",
]
