"""Chip-health & fault-tolerant serving for DT2CAM TCAM arrays.

The paper's robustness claim (§II.C, Fig 7/8) is that accuracy *degrades
gracefully* under stuck-at faults, SA variability, and input noise.  This
package adds the mechanisms a real analog-CAM deployment layers on top of
that raw tolerance (cf. Pedretti et al.'s defect-aware mapping):

  bist.py        — march-style built-in self-test: probe the physical array
                   with synthesized test words, emit a per-row defect map
                   (every row at once on the device; ``run_bist_ref`` is
                   the plain per-row loop).
  repair.py      — spare-row repair: remap defective rows onto the rogue-row
                   spare pool with write-verification through the chip's
                   stuck-element mask; graceful-degradation reporting;
                   ``row_utilization`` counts the first survivors that
                   ``first_survivors`` takes from one launch of the match
                   kernel.
  redundancy.py  — ReplicatedServer: N-modular redundancy across
                   independently-sampled chip instances, majority voting,
                   disagreement metrics.
  canary.py      — golden-vector canary probes + circuit breaker driving the
                   degradation ladder (degraded -> repair -> re-vote ->
                   failed; on the CPU an engine fallback comes first).

``serve.TCAMServer`` wires these together: ``self_test()``, ``repair()``,
``run_canary()`` and a periodic canary that trips the breaker automatically.
"""
from .bist import (
    BistReport,
    behavior_changed_rows,
    march_probes,
    row_match,
    row_signatures,
    run_bist,
    run_bist_ref,
)
from .canary import BreakerState, CanaryProbe, CircuitBreaker, make_canary
from .redundancy import ReplicatedServer, VotedResult, majority_vote
from .repair import (RepairReport, first_survivors, repair_layout,
                     row_utilization, row_utilization_ref)

__all__ = [
    "BistReport", "behavior_changed_rows", "march_probes", "row_match",
    "row_signatures", "run_bist", "run_bist_ref",
    "BreakerState", "CanaryProbe", "CircuitBreaker", "make_canary",
    "ReplicatedServer", "VotedResult", "majority_vote",
    "RepairReport", "first_survivors", "repair_layout", "row_utilization",
    "row_utilization_ref",
]
