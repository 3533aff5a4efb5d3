#!/usr/bin/env python3
"""The program's spans and counters (``repro_torch.obs``) in the
benchmark's cells on the card, through the benchmark's own drivers
(``bench/serve.py``, ``bench/train.py``) at the cell's traffic; nothing
is checked against the reference.  Per cell, in one process:

1. ``--pairs`` alternating pairs of untraced windows of ``--seconds``,
   one with ``obs`` on (spans and counters, no profiler) and one off,
   their end-to-end metrics side by side: what the spans cost;
2. the cell's traced window (``trace_units`` of its traffic) with
   ``obs`` off, as ``bench/run.py --trace 1`` traces it
   (``bench.trace.summarise``);
3. the same with ``obs`` on from the window's start (``reset``) to its
   end (``counters`` after the synchronize), summarised with the spans by
   ``bench.spans.summarise``: device time by span, blocking calls, idle
   in syncs, the named idle gaps, the span metrics (``spans.readings``),
   the counters and the allocator's counts, and every CUDA runtime call
   in the window by name.

Writes the whole record to ``--out`` (``build/span_probe.json``) and prints
a digest.  GPU only.

    python3 tools/span_probe.py [--workload CELL ...] [--seed N]
        [--seconds S] [--pairs N] [--out FILE]
    python3 tools/span_probe.py --sync-sites   # the lines that sync
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = ("qwen3moe-l4.prefill-mix", "qwen3moe-l4.decode-b32",
         "olmo-1b.train-8x2048")


def _runtime_calls(events, w0, w1) -> dict:
    """CUDA runtime and driver call -> [calls, host s] in the window."""
    out: dict = {}
    for e in events:
        a = e.time_range.start
        if e.device_type.name == "CPU" and e.name.startswith("cu") \
                and w0 <= a < w1:
            c = out.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += (e.time_range.end - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def _obs_traced(base):
    """``bench.trace.Traced`` with ``obs`` on in the window and the span
    summary in ``summary``."""
    from bench import spans
    from repro_torch import obs

    class SpanTraced(base):
        def __enter__(self):
            if self.on:
                obs.enable(True)
                obs.reset()
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            if not self.on or exc[0] is not None:
                return False
            obs.enable(False)
            events = self._prof.events()
            s = spans.summarise(events, obs.SPANS)
            s["as_bench_trace"] = {k: self.summary[k] for k in
                                   ("busy_s", "window_s", "idle_gaps")}
            s["counters"] = obs.counters()
            win = next(e for e in events if e.name == "window"
                       and e.device_type.name == "CPU")
            s["runtime_calls"] = _runtime_calls(
                events, win.time_range.start, win.time_range.end)
            self.summary = s
            return False
    return SpanTraced


def _ctx(workload: str, seed: int, seconds: float, trace: bool):
    import torch

    from bench import harness, program
    manifest, cell, conf, traffic, limits = harness.load_cell(workload)
    ctx = harness.Ctx(workload=workload, seed=seed, seconds=seconds,
                      trace=trace, t0=time.perf_counter(),
                      manifest=manifest, cell=cell, conf=conf,
                      traffic=traffic, limits=limits,
                      device=torch.device("cuda", 0),
                      card=torch.cuda.get_device_name(0))
    ctx.cfg = program.port_config(conf)
    ctx.ref = importlib.import_module(
        f"bench.reference.{conf['model_type']}")
    ctx.spec = ctx.ref.spec(conf)
    ctx.ref_shapes = ctx.ref.leaf_shapes(ctx.spec)
    return ctx


def _run(workload: str, seed: int, seconds: float, trace: bool, on: bool):
    from bench import serve, train
    from repro_torch import obs
    ctx = _ctx(workload, seed, seconds, trace)
    driver = {"prefill": serve.prefill, "decode": serve.decode,
              "train": train.train}[ctx.traffic["kind"]]
    obs.enable(on and not trace)        # traced: on in the window only
    try:
        run = driver(ctx)
    finally:
        obs.enable(False)
        obs.reset()
    e2e = {k: v for k, v in run.e2e.items() if k != "setup_s"}
    return ctx, run, e2e


def probe(workload: str, seed: int, seconds: float, pairs: int) -> dict:
    from bench import serve, spans, train
    out: dict = {"workload": workload, "pairs": []}
    for i in range(pairs):
        pair = {}
        for on in ((True, False) if i % 2 else (False, True)):
            pair["on" if on else "off"] = _run(workload, seed + i, seconds,
                                               False, on)[2]
        out["pairs"].append(pair)
    _, run, e2e = _run(workload, seed, seconds, True, False)
    out["traced_off"] = {"e2e": e2e, "units": run.units,
                         **{k: run.trace[k] for k in
                            ("busy_s", "window_s", "device_ops",
                             "idle_gaps")}}
    base = serve.Traced
    serve.Traced = train.Traced = _obs_traced(base)
    try:
        ctx, run, e2e = _run(workload, seed, seconds, True, True)
    finally:
        serve.Traced = train.Traced = base
    s = run.trace
    s.pop("by_op")
    s["e2e"], s["units"] = e2e, run.units
    s["readings"] = spans.readings(s, ctx.traffic["kind"], run.units)
    out["traced_on"] = s
    return out


def sync_sites() -> dict:
    """The port's lines that synchronise the host with the card, under
    ``torch.cuda.set_sync_debug_mode("warn")``: the reduced qwen3-moe's
    prefill and one decode step, the reduced olmo-1b's train step, each
    run once before.  Stage -> "file:line" -> calls."""
    import warnings

    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_cache, init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (build_decode_step, build_prefill_step,
                                   build_train_step, init_train_state)
    dev = torch.device("cuda", 0)
    cfg, ocfg = get_reduced("qwen3_moe_235b_a22b"), get_reduced("olmo_1b")
    params = init_params(cfg, 0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device=dev)
    pre, dec = build_prefill_step(cfg), build_decode_step(cfg)
    train = build_train_step(ocfg, AdamWConfig(), remat="none")
    batch = {k: torch.randint(0, ocfg.vocab_size, (2, 32), device=dev)
             for k in ("tokens", "labels")}

    def prefilled():
        logits, caches = pre(params, {"tokens": tokens},
                             init_cache(cfg, 2, 33, device=dev))
        return logits[:, -1:].argmax(-1), caches

    # stage -> (its inputs, made untraced; the stage on them)
    stages = {
        "prefill": (lambda: init_cache(cfg, 2, 33, device=dev),
                    lambda c: pre(params, {"tokens": tokens}, c)),
        "decode": (prefilled, lambda tc: dec(params, tc[0], tc[1], 32)),
        "train": (lambda: init_train_state(ocfg, 0, device=dev),
                  lambda st: train(st, batch)),
    }
    out = {}
    for name, (make, run) in stages.items():
        run(make())
        arg = make()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run(arg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites: dict = {}
        for w in got:
            path = pathlib.Path(w.filename)
            key = f"{'/'.join(path.parts[-2:])}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
        out[name] = sites
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="*", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=4100000001)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "span_probe.json"))
    ap.add_argument("--sync-sites", action="store_true",
                    help="only list the lines that synchronise")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import run as bench_run
    bench_run._environment()
    import torch
    if not torch.cuda.is_available():
        print("span_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    from bench.harness import _power_limit_w
    res = {"card": torch.cuda.get_device_name(0),
           "power_limit_w": _power_limit_w(), "torch": torch.__version__,
           "cells": []}
    if args.sync_sites:
        print(json.dumps({**res, "sync_sites": sync_sites()}))
        return 0
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for w in args.workload:
        res["cells"].append(probe(w, args.seed, args.seconds, args.pairs))
        out.write_text(json.dumps(res, indent=1))
        c = res["cells"][-1]
        t = c["traced_on"]
        print(json.dumps({
            "workload": w, "pairs": c["pairs"],
            "traced_off": {k: c["traced_off"][k] for k in
                           ("e2e", "busy_s", "window_s", "idle_gaps")},
            "traced_on": {k: t[k] for k in
                          ("e2e", "busy_s", "window_s", "span_busy",
                           "unlaunched_s", "blocking", "sync_idle_s",
                           "sync_calls", "idle_gaps", "counters",
                           "readings")}}), flush=True)
    print(json.dumps({"card": res["card"],
                      "power_limit_w": res["power_limit_w"],
                      "torch": res["torch"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
