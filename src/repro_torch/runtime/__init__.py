"""Fault-tolerant training runtime: retries, straggler detection,
preemption handling, elastic resume."""
from .fault import FaultTolerantLoop, StragglerMonitor

__all__ = ["FaultTolerantLoop", "StragglerMonitor"]
