"""expert_fill.decode: the share of the expert buffer's rows that the MoE
layers computed for a dispatch they kept, over the traced window, in %:
100 x ``moe.kept`` / ``moe.slots`` (``repro_torch.obs``' counters, which
count while the profiler records).  Notes: the share of dispatches dropped
over capacity, 1 - kept / dispatched, and the three counts.  None from a
program without the counters."""
from bench.fill import expert_fill


def read(rec):
    if rec["kind"] != "decode":
        return None
    return expert_fill()
