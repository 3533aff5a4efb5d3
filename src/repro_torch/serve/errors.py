"""Typed serving failures.

Every submitted request resolves — either with a ``RequestResult`` or with
one of these exceptions on its Future.  Callers can branch on the type:

* ``Rejected`` — load shedding: the bounded request queue was full at submit
  time (``ServeConfig.max_queue``).  Retry later / elsewhere.
* ``DeadlineExceeded`` — the request sat in the queue past its per-request
  deadline (``ServeConfig.request_timeout_s``) and was dropped at batch
  formation instead of being served late.
* ``ComputeFailed`` — the batch compute raised even after
  ``ServeConfig.max_retries`` retry-with-backoff attempts; the original
  exception is chained as ``__cause__``.
"""
from __future__ import annotations

__all__ = ["ServingError", "Rejected", "DeadlineExceeded", "ComputeFailed"]


class ServingError(Exception):
    """Base class for typed serving failures."""


class Rejected(ServingError):
    """Request shed at admission: the bounded queue was full."""


class DeadlineExceeded(ServingError):
    """Request expired in the queue before its batch was formed."""


class ComputeFailed(ServingError):
    """Batch compute failed after exhausting its retry budget."""
