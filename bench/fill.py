"""The MoE counters of the traced window, for the ``expert_fill.*``
readers: ``repro_torch.obs`` counts while a profiler records, so the
traced window's counts are there without a switch."""
from __future__ import annotations

__all__ = ["expert_fill"]


def expert_fill() -> dict | None:
    """100 x kept / slots, with the dropped share and the counts, since
    the last read (the counters are reset after it); None where the
    program has no counters or counted nothing."""
    try:
        from repro_torch import obs
    except ImportError:                  # a program without the counters
        return None
    c = obs.counters()
    obs.reset()
    slots, kept = c.get("moe.slots", 0), c.get("moe.kept", 0)
    dispatched = c.get("moe.dispatched", 0)
    if not slots or not dispatched:
        return None
    return {"value": 100.0 * kept / slots,
            "dropped": 100.0 * (1.0 - kept / dispatched),
            "kept": kept, "slots": slots, "dispatched": dispatched}
