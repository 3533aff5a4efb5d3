"""The traced window's numbers with the program's own spans in it
(``repro_torch.obs``, switched on for the window): ``bench.trace``'s
``busy_s``, ``window_s``, ``by_op`` and ``device_ops``, computed as there,
and besides:

- ``span_busy``: program span -> the device-busy seconds of the
  operations launched inside it, clipped to the window.  Each device
  operation is matched by correlation id to the runtime call that
  launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...); the
  program spans open on that call's thread at that moment own it, or,
  where that thread has none open (autograd's backward thread), the spans
  open on any thread.  A span's device-side copy on the card's timeline
  is no operation here, as ``bench.trace`` treats the harness's;
- ``unlaunched_s``: device-busy seconds whose launch was not found;
- ``blocking``: blocking CUDA runtime call -> [calls, host seconds] of
  those that start in the window (``BLOCKING``);
- ``sync_idle_s``: idle seconds whose midpoint falls in a blocking call
  while a ``step.*`` span is open; ``sync_calls``: innermost program span
  -> blocking call -> calls made inside it;
- ``idle_gaps``: each idle gap named ``<harness span>/<innermost program
  span>[/<blocking call>]`` by its midpoint; a gap under no program span
  keeps ``bench.trace``'s bare name, so the gaps summed by their harness
  prefix are ``bench.trace``'s attribution.

``readings`` turns a summary into the per-layer metrics that read spans
(``METRICS``).  The harness does not call this module yet: ``bench/trace.py``
would switch ``obs`` on in ``Traced`` and call ``summarise`` here.
"""
from __future__ import annotations

import re

from .trace import SPANS, TOP, _union

__all__ = ["BLOCKING", "METRICS", "summarise", "readings"]

# runtime calls that hold the host until the device (or the allocator) is
# done: the synchronisations, synchronous copies, frees and allocations
BLOCKING = re.compile(r"^(cudaStreamSynchronize|cudaDeviceSynchronize|"
                      r"cudaEventSynchronize|cudaMemcpy(?!.*Async)\w*|"
                      r"cudaFree|cudaMalloc)$")
# metric -> (traffic kind, span read) for the per-unit device ms metrics
METRICS = {
    "attention_ms.prefill": ("prefill", "lm.attention"),
    "moe_ms.prefill": ("prefill", "lm.moe"),
    "attention_ms.decode": ("decode", "lm.attention"),
    "moe_ms.decode": ("decode", "lm.moe"),
    "expert_cast_ms.decode": ("decode", "moe.cast"),
    "backward_ms.train": ("train", "train.backward"),
    "update_ms.train": ("train", "train.update"),
}


def _dev(e) -> str:
    return e.device_type.name


def _open_at(spans: list, points: list) -> list:
    """For each point (time, thread) the spans (name, start, end, thread)
    open there on that thread, outermost first; where that thread has
    none (or the thread is None), those open on any thread, by start."""
    ev = [(a, 0, i) for i, (_, a, _, _) in enumerate(spans)]
    ev += [(b, 2, i) for i, (_, _, b, _) in enumerate(spans)]
    ev += [(t, 1, j) for j, (t, _) in enumerate(points)]
    ev.sort()
    now: dict = {}
    out = [()] * len(points)
    for _, kind, i in ev:
        if kind == 0:
            now[i] = spans[i]
        elif kind == 2:
            now.pop(i, None)
        elif now:
            th = points[i][1]
            out[i] = tuple(s for s in now.values() if s[3] == th) or tuple(
                sorted(now.values(), key=lambda s: s[1]))
    return out


def summarise(events, program=(), top: int = TOP) -> dict:
    """``bench.trace.summarise``'s numbers and the ones above, from the
    profiled events (microseconds); ``program``: the program's span
    names (``repro_torch.obs.SPANS``)."""
    program = frozenset(program)
    win = [e for e in events if e.name == "window" and _dev(e) == "CPU"]
    if not win:
        raise RuntimeError("the traced window's span is missing")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host, spans, calls, launch = [], [], [], [], {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name in SPANS or e.name == "window" or e.name in program:
            if _dev(e) == "CPU" and e.name in SPANS:
                host.append((e.name, a, b))
            elif _dev(e) == "CPU" and e.name in program:
                spans.append((e.name, a, b, e.thread))
            continue
        if _dev(e) == "CUDA" and b > a:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((e.name, a, b, e.id))
        elif _dev(e) == "CPU" and e.name.startswith("cu"):
            launch[e.id] = (a, e.thread)
            if BLOCKING.match(e.name) and w0 <= a < w1:
                calls.append((e.name, a, b, e.thread))
    busy, pieces = _union([(a, b) for _, a, b, _ in dev])
    by_op: dict = {}
    for n, a, b, _ in dev:
        by_op[n] = by_op.get(n, 0.0) + (b - a)

    # device operations by the program spans open at their launch
    found = [(i, launch[c]) for i, (_, _, _, c) in enumerate(dev)
             if c in launch]
    owned: dict = {}
    for (i, _), open_ in zip(found, _open_at(spans, [p for _, p in found])):
        for name in {s[0] for s in open_}:
            owned.setdefault(name, []).append(dev[i][1:3])
    span_busy = {n: _union(iv)[0] / 1e6 for n, iv in owned.items()}
    seen = {i for i, _ in found}
    unlaunched = _union([d[1:3] for i, d in enumerate(dev)
                         if i not in seen])[0] / 1e6

    # idle gaps, named by harness span, program span and blocking call
    gaps, edge = [], w0
    for a, b in pieces + [[w1, w1]]:
        if a > edge:
            gaps.append(((edge + a) / 2, a - edge))
        edge = max(edge, b)
    mids = [(m, None) for m, _ in gaps]
    in_span = _open_at(spans, mids)
    in_call = _open_at(calls, mids)
    named: dict = {}
    sync_idle = 0.0
    for (mid, length), sp, cl in zip(gaps, in_span, in_call):
        name = next((n for n, s0, s1 in host if s0 <= mid < s1),
                    "between spans")
        if sp:
            name += "/" + sp[-1][0]
            if cl:
                name += "/" + cl[-1][0]
                if any(s[0].startswith("step.") for s in sp):
                    sync_idle += length
        named[name] = named.get(name, 0.0) + length

    blocking: dict = {}
    sync_calls: dict = {}
    for (n, a, b, _), open_ in zip(
            calls, _open_at(spans, [(a, th) for _, a, _, th in calls])):
        c = blocking.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) / 1e6
        if open_:
            by = sync_calls.setdefault(open_[-1][0], {})
            by[n] = by.get(n, 0) + 1

    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
        "by_op": {n: t / 1e6 for n, t in by_op.items()},
        "device_ops": [[n[:160], t / 1e6] for n, t in top_ops],
        "idle_gaps": [[n, t / 1e6] for n, t in
                      sorted(named.items(), key=lambda kv: -kv[1])[:top]],
        "span_busy": span_busy, "unlaunched_s": unlaunched,
        "blocking": blocking, "sync_idle_s": sync_idle / 1e6,
        "sync_calls": sync_calls,
    }


def readings(summary: dict, kind: str, units: int) -> dict:
    """The span metrics of a summary of ``units`` batches or steps of
    ``kind`` traffic: each ``METRICS`` entry's device ms per unit with its
    share of ``busy_s``, and ``idle_in_sync.<kind>`` (% of the window).
    Empty where the window has no device operation."""
    busy = summary.get("busy_s") or 0.0
    if not busy or not units:
        return {}
    out = {}
    for name, (k, span) in METRICS.items():
        if k == kind:
            s = summary["span_busy"].get(span, 0.0)
            out[name] = {"value": 1e3 * s / units,
                         "busy_share": 100.0 * s / busy}
    out[f"idle_in_sync.{kind}"] = {
        "value": 100.0 * summary["sync_idle_s"] / summary["window_s"],
        "calls_per_unit": {sp: {c: n / units for c, n in by.items()}
                           for sp, by in summary["sync_calls"].items()}}
    return out
