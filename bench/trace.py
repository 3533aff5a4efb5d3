"""The traced run's device numbers, from ``torch.profiler`` (CUPTI):
the union of the device's operation intervals inside the traced window,
the union of its collectives' (NCCL kernels, names starting ``nccl``),
every operation's device time by name (``by_op``, for the per-layer
readers; the ten largest are the result's ``device_ops``), and the idle
gaps named after the harness's own spans (``record_function`` around each
call into a layer).  A run of several cards traces every rank and
averages the times over them (``across_ranks``).

Spans are the harness's, around its calls into the program: ``make
inputs``, ``allocate caches``, ``step call``, ``greedy pick``, ``sync``;
the whole traced stretch is the span ``window``.  Spans inside the
program are not there yet.
"""
from __future__ import annotations

__all__ = ["SPANS", "span", "Traced", "summarise", "across_ranks"]

SPANS = ("make inputs", "allocate caches", "step call", "greedy pick",
         "sync")
TOP = 10


def span(name: str):
    """A ``record_function`` span of the harness (costs a few
    microseconds a call untraced)."""
    from torch.profiler import record_function
    return record_function(name)


class Traced:
    """``with Traced(on) as t:`` profiles the block when ``on``; then
    ``t.summary`` holds ``summarise``'s numbers (None when off)."""

    def __init__(self, on: bool, on_card: bool = True):
        self.on, self.on_card = on, on_card
        self.summary = None
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.on_card:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._win = span("window")
            self._win.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        if self.on_card:
            import torch
            torch.cuda.synchronize()
        self._win.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarise(self._prof.events())
        return False


def _union(spans):
    """Total length of the union of (a, b) intervals, and the union's
    pieces."""
    pieces = []
    for a, b in sorted(spans):
        if pieces and a <= pieces[-1][1]:
            pieces[-1][1] = max(pieces[-1][1], b)
        else:
            pieces.append([a, b])
    return sum(b - a for a, b in pieces), pieces


def _collective(e) -> bool:
    """An NCCL kernel (c10d's ``nccl:<op>`` annotations are left out
    before)."""
    return (e.name.startswith("nccl")
            and not getattr(e, "is_user_annotation", False))


def summarise(events) -> dict:
    """``busy_s``, ``window_s``, ``collective_s``, ``by_op``,
    ``device_ops`` and ``idle_gaps`` (seconds) of the profiled events
    (microseconds)."""
    win = [e for e in events if e.name == "window"
           and e.device_type.name == "CPU"]
    if not win:
        raise RuntimeError("the traced window's span is missing")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host, coll = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("nccl:"):
            continue        # c10d's annotation around an NCCL kernel
        if e.name in SPANS or e.name == "window":
            # a span's copy on the device's timeline is no operation; an
            # idle gap is named after the harness span (not the window)
            # that the host was in
            if e.name in SPANS and e.device_type.name == "CPU":
                host.append((e.name, a, b))
            continue
        if e.device_type.name == "CUDA" and b > a:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((e.name, a, b))
                if _collective(e):
                    coll.append((a, b))
    busy, pieces = _union([(a, b) for _, a, b in dev])
    coll, _ = _union(coll)
    by_op: dict = {}
    for n, a, b in dev:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    gaps, edge = {}, w0
    for a, b in pieces + [[w1, w1]]:
        if a > edge:
            mid = (edge + a) / 2
            name = next((n for n, s0, s1 in host if s0 <= mid < s1),
                        "between spans")
            gaps[name] = gaps.get(name, 0.0) + (a - edge)
        edge = max(edge, b)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
        "collective_s": coll / 1e6,
        "by_op": {n: t / 1e6 for n, t in by_op.items()},
        "device_ops": [[n[:160], t / 1e6] for n, t in top],
        "idle_gaps": [[n, t / 1e6] for n, t in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }



def across_ranks(summary: dict, group, world: int) -> dict:
    """Rank 0's ``summary`` (its operations and idle gaps) with
    ``busy_s``, ``window_s`` and ``collective_s`` the mean over every
    rank's trace, and each rank's under ``<name>_by_rank``."""
    import torch.distributed as dist
    keys = ("busy_s", "window_s", "collective_s")
    every = [None] * world
    dist.all_gather_object(every, {k: summary[k] for k in keys}, group=group)
    out = dict(summary)
    for k in keys:
        out[k] = sum(r[k] for r in every) / world
        out[k + "_by_rank"] = [r[k] for r in every]
    return out
