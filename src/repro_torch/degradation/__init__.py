"""Temporal degradation management: drift-aware scrubbing & refresh.

Static non-idealities (stuck-at faults, SA variability, input noise) are
modelled in ``core.nonideal`` and detected/repaired by ``repro.reliability``.
This package owns the *temporal* axis: memristive conductance drifts and
retention decays between writes (Pedretti et al. 2021 call this out as a
first-order threat to in-memory tree inference), so a long-running deployment
must track per-row stress, watch sensing margins shrink, and refresh rows
before they functionally misread.

Building blocks:

* ``ScrubScheduler`` — per-row write timestamps + read counts on a virtual
  clock; ``due()`` picks the rows to refresh under a ``ScrubPolicy``
  (margin-threshold or periodic).
* ``plan_refresh`` — lowers a refresh to the lifecycle ``WritePlan``
  machinery (one reinforcing pulse per resistive element), so refresh
  energy/time surface through ``core.energy.reprogram_figures`` and the
  pulses debit the same ``WearTracker`` endurance ledger as redeploys.
* ``layout_margins`` — glue from a layout + ``DriftModel`` + per-row stress
  to ``core.energy.sensing_margins``, as tensor ops on the drift model's
  device (``layout_margins_ref``: the copied numpy bodies).

``serve.TCAMServer`` wires these into a background maintenance pass.
"""
from .scheduler import (
    ScrubPolicy,
    ScrubReport,
    ScrubScheduler,
    layout_margins,
    layout_margins_ref,
    plan_refresh,
)

__all__ = [
    "ScrubPolicy",
    "ScrubReport",
    "ScrubScheduler",
    "layout_margins",
    "layout_margins_ref",
    "plan_refresh",
]
