"""collective_share.prefill: the share of the traced window in which the
card ran a collective, in %: 100 x the union of the profiler's NCCL kernel
intervals (names starting ``nccl``: the f32 all-reduces of the attention
output and of the experts' combine, the router logits' and the greedy
pick's all-gathers) over the window, waiting inside a kernel for a slower
rank included, averaged over the ranks.  Notes: each rank's share.  None
where the run traced no collective (one card)."""


def read(rec):
    if rec["kind"] != "prefill" or not rec.get("collective_s"):
        return None
    by_rank = [100.0 * c / w for c, w in zip(rec["collective_s_by_rank"],
                                             rec["window_s_by_rank"])]
    return {"value": 100.0 * rec["collective_s"] / rec["window_s"],
            "by_rank": by_rank}
