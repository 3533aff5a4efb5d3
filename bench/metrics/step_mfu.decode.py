"""step_mfu.decode: the whole decode step's share of the card's roofline over
the traced window: the least time its work needs (the larger of its
operations over the bf16 peak and its bytes over the memory rate, times
the cards used; `bench.work`) over the window's length, in %."""
from bench.work import least_seconds


def read(rec):
    if rec["kind"] != "decode" or not rec.get("window_s"):
        return None
    n = rec["chips"]
    least, by = least_seconds(rec["work"], rec["flops"] * n, rec["bw"] * n)
    return {"value": 100.0 * least / rec["window_s"], "bound": by}
