"""Fault-tolerant checkpointing: atomic save, retention, auto-resume, in
the JAX package's on-disk layout."""
from .manager import CheckpointManager, restore_resharded

__all__ = ["CheckpointManager", "restore_resharded"]
