"""Spans and counters inside the serving and train steps, off by default.

``enable(True)`` turns the spans on: each ``span(name)`` is then a
``torch.profiler.record_function``, so a ``torch.profiler.profile`` run
around the step records it on the profiler's own clock, beside the
device's operations; there is no second timer.  Off, ``span`` returns one
shared ``contextlib.nullcontext()``: no dispatcher call, no allocation, no
launch.

``add(name, value)`` counts while the spans are on or while a
``torch.profiler`` records, so a profiled run counts without the switch;
otherwise it does nothing.  A Python int adds on the host; a tensor adds
into a device-resident accumulator with ``add_``, and nothing is read back
until ``counters()``, which reads every accumulator once (call it after a
``torch.cuda.synchronize()``).  A caller that computes a tensor only to
count it asks ``counting()`` first.

Spans (where each opens):

- ``step.prefill``, ``step.decode``, ``step.train``: the steps that
  ``train.build_prefill_step``, ``build_decode_step`` and
  ``build_train_step`` return, sharded variants included;
- ``train.forward``, ``train.backward``: ``loss_fn`` and
  ``torch.autograd.grad`` in ``train.step._value_and_grad``;
- ``train.update``: ``ef_compress`` and ``adamw_update`` of a train step;
- ``lm.attention``: ``models.lm._attention_mixer``, whole;
- ``lm.moe``: ``models.moe.moe_ffn``, whole;
- ``moe.cast``: the expert weights' cast to the compute dtype (once per
  layer call in serving, once per token group with a gradient);
- ``moe.route``: the router; ``moe.dispatch``: ranking each dispatch in
  its expert and scattering the kept ones into the expert buffer;
  ``moe.experts``: the experts' three products and activation;
  ``moe.combine``: gathering and weighting the experts' outputs.

Counters, in ``models.moe._experts`` (every MoE path reaches it):
``moe.passes`` (host: expert passes, one a layer call in serving, one a
token group with a gradient), ``moe.pass_groups`` (host: the token groups
those passes computed side by side), ``moe.dispatched`` (host: tokens x k),
``moe.kept`` (device: dispatches within capacity and on this rank's
experts), ``moe.slots`` (host: expert buffer rows computed, experts x
rows).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["SPANS", "COUNTERS", "enable", "enabled", "span", "counting",
           "add", "reset", "counters"]

SPANS = ("step.prefill", "step.decode", "step.train", "train.forward",
         "train.backward", "train.update", "lm.attention", "lm.moe",
         "moe.cast", "moe.route", "moe.dispatch", "moe.experts",
         "moe.combine")
COUNTERS = ("moe.passes", "moe.pass_groups", "moe.dispatched", "moe.kept",
            "moe.slots")
# the caching allocator's counts whose change ``counters`` reports
ALLOCATOR = ("num_device_alloc", "num_device_free", "num_alloc_retries",
             "num_sync_all_streams")

_NULL = contextlib.nullcontext()


class _State:
    on = False
    host: dict = {}
    device: dict = {}
    allocator: dict | None = None


def enable(on: bool) -> None:
    """Turn the spans (and counting) on or off."""
    _State.on = bool(on)


def enabled() -> bool:
    return _State.on


def span(name: str):
    """``record_function(name)`` while on; the shared null context off."""
    if not _State.on:
        return _NULL
    return torch.profiler.record_function(name)


def counting() -> bool:
    """Whether ``add`` counts: spans on, or a profiler recording."""
    return _State.on or torch._C._autograd._profiler_enabled()


def add(name: str, value) -> None:
    """Add ``value`` (an int, or a tensor on its device) to ``name``."""
    if not counting():
        return
    if isinstance(value, torch.Tensor):
        key = (name, value.device)
        acc = _State.device.get(key)
        if acc is None:
            acc = _State.device[key] = torch.zeros(
                (), dtype=torch.int64, device=value.device)
        acc.add_(value)
    else:
        _State.host[name] = _State.host.get(name, 0) + int(value)


def _allocator() -> dict | None:
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in ALLOCATOR}


def reset() -> None:
    """Zero every counter and take the allocator's counts as the base."""
    _State.host, _State.device = {}, {}
    _State.allocator = _allocator()


def counters() -> dict:
    """Every counter since ``reset()`` (device ones read back once), and
    where a card is in use, the allocator's counts' changes since then."""
    out = dict(_State.host)
    for (name, _), acc in _State.device.items():
        out[name] = out.get(name, 0) + int(acc.item())
    now = _allocator()
    if now is not None:
        base = _State.allocator or {}
        out.update({k: v - base.get(k, 0) for k, v in now.items()})
    return out
