"""Warm build cache for the serving engine.

The engine funnels every batch through a ``BucketPolicy`` shape and memoizes
one built batch function per ``(bucket, engine, layout_id)``: it owns the
bucket's device input buffer and the layout's device-resident operands, and
its first call loads the CUDA kernel.  Total builds over a server's lifetime
are bounded by ``len(buckets) x len(engines)`` per layout — the serve tests
assert exactly this via the hit/miss counters kept here.

The cache is optionally *bounded*: with ``maxsize`` set, the least recently
used entry is evicted once the table is full (``evictions`` counts them), so
a long-lived server cycling through layouts (repair re-keys, lifecycle
promotions) cannot grow its compiled-function table without limit.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

__all__ = ["CompileCache"]


class CompileCache:
    """Memoize compiled batch functions keyed ``(bucket, engine, layout_id)``.

    ``builder(bucket, engine)`` is invoked exactly once per distinct live key
    (the layout is fixed per cache instance; ``layout_id`` keys guard against
    accidental sharing across layouts).  Thread-safe: the builder runs under
    the cache lock so concurrent workers never double-compile a key.

    ``maxsize=None`` (default) keeps every entry; an integer bounds the table
    with LRU eviction — an evicted key rebuilds (a fresh miss) on next use.
    """

    def __init__(self, builder: Callable[[int, str], Callable[..., Any]],
                 layout_id: str, *, maxsize: Optional[int] = None) -> None:
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"maxsize must be >= 1 or None, got {maxsize}")
        self._builder = builder
        self._layout_id = layout_id
        self._maxsize = maxsize
        self._fns: OrderedDict[tuple[int, str, str], Callable[..., Any]] = \
            OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, bucket: int, engine: str) -> Callable[..., Any]:
        key = (bucket, engine, self._layout_id)
        with self._lock:
            fn = self._fns.get(key)
            if fn is None:
                self.misses += 1
                fn = self._builder(bucket, engine)
                self._fns[key] = fn
                if (self._maxsize is not None
                        and len(self._fns) > self._maxsize):
                    self._fns.popitem(last=False)
                    self.evictions += 1
            else:
                self.hits += 1
                self._fns.move_to_end(key)
            return fn

    def __len__(self) -> int:
        return len(self._fns)

    def stats(self) -> dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "size": len(self),
            "maxsize": self._maxsize,
        }
