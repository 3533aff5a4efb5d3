"""device_idle.prefill: the share of the traced window in which no operation
ran on the device (1 minus the union of the profiler's device intervals
over the window), in %."""


def read(rec):
    if rec["kind"] != "prefill" or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
