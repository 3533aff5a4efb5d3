#!/usr/bin/env python3
"""Where the LM serving path's time goes on the card: one prefill of
``chip_smoke.LM_BATCH`` x prompt tokens and ``DECODE_STEPS`` greedy decode
steps of one of ``chip_smoke.py``'s LM configurations at every published
width (by default phase 9's qwen3-moe-235b-a22b cut to ``LM_LAYERS``; or a
configuration of phase 10's ``LM_FAMILIES``, at its depth and prompt),
each traced by ``torch.profiler`` after a warm-up.  Prints, per mode, the
wall time, the device's busy time and idle share, and the ``TOP_ROWS``
operators by device time, most first.  GPU only; about a minute per
configuration.

    python3 tools/lm_profile.py [arch ...]
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DECODE_STEPS = 4    # traced decode steps
TOP_ROWS = 14       # operators listed per mode


def device_busy_us(prof) -> float:
    """Union of the device kernels' and copies' intervals, microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type.name == "CUDA" and e.time_range.end
                   > e.time_range.start)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def traced(fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = device_busy_us(prof)
    # operators on the host, each with the device time of the kernels it
    # launched itself (the kernels' own rows would count that time twice)
    rows = sorted((r for r in prof.key_averages()
                   if r.device_type.name == "CPU"),
                  key=lambda r: r.self_device_time_total, reverse=True)
    return {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "by_operator_ms": [(r.key, r.count, r.self_device_time_total / 1e3)
                           for r in rows[:TOP_ROWS]
                           if r.self_device_time_total > 0],
    }


def profile_arch(arch: str) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    layers, prompt = cs.LM_FAMILIES.get(arch, (cs.LM_LAYERS, cs.LM_PROMPT))
    batch = cs.LM_BATCH
    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = init_params(cfg, cs.LM_SEED, device=dev)
    b = make_batch(cfg, batch, prompt, step=1, seed=cs.LM_SEED)
    toks = torch.from_numpy(b["tokens"]).to(dev)
    kw = ({"frames": torch.from_numpy(b["frames"]).to(dev)}
          if cfg.is_encdec else {})

    def fresh():
        # a prefill continues a recurrent state it finds in the caches
        return init_cache(cfg, batch, prompt + DECODE_STEPS + 1, device=dev)

    logits, caches = prefill(params, cfg, toks, fresh(), **kw)   # warm-up
    decode_step(params, cfg, logits.argmax(-1), caches, prompt)
    caches = fresh()
    out = {"prefill": traced(lambda: prefill(params, cfg, toks, caches,
                                             **kw))}
    tok = logits.argmax(-1)

    def steps():
        nonlocal tok
        for i in range(DECODE_STEPS):
            lg, _ = decode_step(params, cfg, tok, caches, prompt + i)
            tok = lg.argmax(-1)
    out["decode"] = traced(steps)
    out["decode"]["steps"] = DECODE_STEPS
    return out


def main() -> int:
    import gc

    import torch
    if not torch.cuda.is_available():
        print("lm_profile: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    for arch in sys.argv[1:] or [cs.LM_ARCH]:
        for mode, rec in profile_arch(arch).items():
            print(json.dumps({"arch": arch, mode: rec}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
