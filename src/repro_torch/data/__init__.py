"""Deterministic, resumable synthetic token pipeline."""
from .pipeline import TokenPipeline, make_batch

__all__ = ["TokenPipeline", "make_batch"]
