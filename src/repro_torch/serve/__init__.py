"""Serving engine for compiled DT2CAM models on the GPU (single tree or forest).

    >>> from repro_torch.serve import TCAMServer
    >>> with TCAMServer(model.compiled) as server:
    ...     preds = [r.prediction for r in server.serve(X)]
    ...     stats = server.metrics()

  engine.py   — TCAMServer: queue, worker, futures, engine fallback, metrics
  batching.py — BucketPolicy (padded batch shapes) + AdaptiveBatcher
                (flush on max-batch or deadline)
  cache.py    — CompileCache: one built batch function per
                (bucket, engine, layout)
  metrics.py  — counters + p50/p99 latency + modelled nJ/dec, M dec/s
  errors.py   — typed serving failures (Rejected / DeadlineExceeded /
                ComputeFailed); every Future resolves with one or a result
"""
from .batching import AdaptiveBatcher, BucketPolicy
from .cache import CompileCache
from .engine import RequestResult, ServeConfig, TCAMServer
from .errors import ComputeFailed, DeadlineExceeded, Rejected, ServingError
from .metrics import LatencyStats, ServeMetrics

__all__ = [
    "AdaptiveBatcher", "BucketPolicy", "CompileCache",
    "RequestResult", "ServeConfig", "TCAMServer",
    "LatencyStats", "ServeMetrics",
    "ServingError", "Rejected", "DeadlineExceeded", "ComputeFailed",
]
