"""Serving drivers: ``prefill`` (a closed loop of prefill batches, each
into fresh caches and through its greedy first token) and ``decode``
(sessions prefilled in set-up, then greedy decode steps of all of them
together), through the port's ``build_prefill_step`` /
``build_decode_step``.

Each returns a ``Run``: the end-to-end numbers over the window, the work
of the traced stretch for the per-layer readers, and what the timed path
produced (``kept``), which ``bench.check`` holds against the reference
once the program's state is freed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import generate
from .program import port_params
from .trace import Traced, across_ranks, span
from .work import Sizes, lm_work

__all__ = ["Run", "prefill", "decode", "free_program"]


@dataclasses.dataclass
class Run:
    attempted: int
    failed: int
    e2e: dict                     # end-to-end metric -> value
    # the window's work ({"bf16_ops", "f32_ops", "bytes"}); decode gives
    # the sizes it is counted from once the check knows the experts read
    work: dict
    units: int                    # batches or steps in the window
    trace: dict | None            # trace.summarise's numbers
    memory_peak: int
    kept: dict                    # the timed path's outputs, for the check


def free_program() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _weight_bytes(params) -> int:
    """Every weight a step reads once (f32), the embedding table not:
    its rows gathered are counted apart."""
    total = 0
    stack = [params]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack += [v for k, v in t.items() if k != "embed"]
        else:
            total += t.numel() * t.element_size()
    return total


def _end(ctx, t_start) -> bool:
    return time.perf_counter() - t_start >= ctx.seconds


def _stop(ctx, t_start) -> bool:
    """Whether the window ends here: rank 0's clock decides for every
    rank, so that all run the same batches."""
    if ctx.world == 1:
        return _end(ctx, t_start)
    import torch.distributed as dist
    flag = torch.tensor([ctx.rank == 0 and _end(ctx, t_start)],
                        dtype=torch.int64)
    dist.broadcast(flag, 0, group=ctx.host)
    return bool(flag)


def _ranks_max(ctx, value: int) -> int:
    """The largest of every rank's ``value``."""
    if ctx.world == 1:
        return value
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=ctx.host)
    return int(t)


def _whole(t):
    """A sharded step's ``DTensor`` gathered whole (a collective); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _gather_kept(ctx, batches: list) -> None:
    """Each kept batch's keys and values gathered whole, after the window,
    and held by the rank that checks it (``check.checker``) alone."""
    from .check import checker
    for j, bt in enumerate(batches):
        mine = checker(ctx, j) == ctx.rank
        whole = {kind: {n: _whole(leaves[n]) for n in ("k", "v")}
                 for kind, leaves in bt["caches"].items()}
        bt["caches"] = whole if mine else None


def prefill(ctx) -> Run:
    from repro_torch.models import init_cache
    from repro_torch.train import build_prefill_step
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    on_card = dev.type == "cuda"
    rules = ctx.rules
    params = port_params(cfg, ctx.conf, ctx.ref_shapes, ctx.seed, dev,
                         rules)
    ctx.mark("weights")
    step = build_prefill_step(cfg, rules)
    vocab = cfg.vocab_size
    # the batches the check recomputes: ``check_batches`` of the first
    # ``check_among``, drawn from the seed, the first of the longest rows
    # among them
    among, cycle = traffic["check_among"], len(traffic["cycle"])
    plan = [s for s, _ in zip(generate.batch_shapes(traffic, ctx.seed),
                              range(among))]
    longest = max(range(among), key=lambda i: (plan[i][1], -i))
    rng = np.random.default_rng([int(ctx.seed), 3])
    others = [i for i in range(among) if i != longest]
    check = {longest, *rng.choice(others, traffic["check_batches"] - 1,
                                  replace=False).tolist()}
    gen = generate.batch_shapes(traffic, ctx.seed)     # plan comes first

    def batch(stream, index, shape, keep_caches):
        b, s = shape
        with span("make inputs"):
            ids = generate.uniform_ids(ctx.seed, stream, index, b, s, vocab)
            tokens = torch.from_numpy(ids).to(dev, non_blocking=True)
        with span("allocate caches"):
            caches = init_cache(cfg, b, s, device=dev, rules=rules)
        with span("step call"):
            logits, caches = step(params, {"tokens": tokens}, caches)
        with span("greedy pick"):
            if rules is not None:       # the vocab's slices gathered
                logits = _whole(logits)
            last = logits[:, -1]
            pick = last.argmax(-1)
        out = {"shape": shape, "logits": last, "pick": pick}
        if keep_caches:
            out["ids"], out["caches"] = ids, caches
        return out

    # warm-up: every shape of the cycle once, on ids of their own
    for j, shape in enumerate(sorted(set(plan))):
        batch(generate.WARMUP, j, shape, False)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0

    outs = []
    units = traffic["trace_units"] if ctx.trace else None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if ctx.world > 1:
        import torch.distributed as dist
        dist.barrier(group=ctx.host)    # every rank starts its window here
    with Traced(ctx.trace, on_card) as tr:
        t_start = time.perf_counter()
        i = 0
        while True:
            outs.append(batch(generate.WINDOW, i, next(gen), i in check))
            i += 1
            if units is not None:
                if i >= units:
                    break
            elif i > max(check) and i % cycle == 0 and _stop(ctx, t_start):
                break                   # at a whole cycle: the mix's work
        with span("sync"):
            if on_card:
                torch.cuda.synchronize()
            if ctx.world > 1:           # the slowest rank's end
                dist.barrier(group=ctx.host)
        elapsed = time.perf_counter() - t_start
    peak = _ranks_max(ctx, torch.cuda.max_memory_allocated()
                      if on_card else 0)
    summary = tr.summary
    if ctx.world > 1 and summary is not None:
        summary = across_ranks(summary, ctx.host, ctx.world)
    tokens = sum(o["shape"][0] * o["shape"][1] for o in outs)
    rows = sum(o["shape"][0] for o in outs)
    work = {"bf16_ops": 0, "f32_ops": 0, "bytes": 0}
    wb = _weight_bytes(params)
    for o in outs:
        w = lm_work(Sizes.of(cfg), wb, *o["shape"])
        for k in work:
            work[k] += w[k]
    if max(check) >= len(outs):
        raise RuntimeError("the traced stretch ended before the batches "
                           "that the check recomputes")
    kept = {"kind": "prefill",
            "batches": [o for i, o in enumerate(outs) if i in check]}
    del params, step, outs
    free_program()
    if rules is not None:
        _gather_kept(ctx, kept["batches"])
        free_program()
    return Run(attempted=rows, failed=0,
               e2e={"prefill_tokens_per_s": tokens / elapsed,
                    "setup_s": setup_s},
               work=work, units=i, trace=summary, memory_peak=peak,
               kept=kept)


def decode(ctx) -> Run:
    from repro_torch.models import init_cache
    from repro_torch.train import build_decode_step, build_prefill_step
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    on_card = dev.type == "cuda"
    b, prompt = traffic["sessions"], traffic["prompt"]
    slots = prompt + traffic["free_slots"]
    params = port_params(cfg, ctx.conf, ctx.ref_shapes, ctx.seed, dev)
    ctx.mark("weights")
    ids = generate.uniform_ids(ctx.seed, generate.PROMPTS, 0, b, prompt,
                               cfg.vocab_size)
    caches = init_cache(cfg, b, slots, device=dev)
    pre = build_prefill_step(cfg)
    step = build_decode_step(cfg)
    logits, caches = pre(params, {"tokens": torch.from_numpy(ids).to(dev)},
                         caches)
    tok = logits[:, -1:].argmax(-1)                   # (B, 1)
    # warm-up: the first step, which the window writes again alike
    step(params, tok, caches, prompt)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0

    # the steps whose logits the check compares: every ``stride``-th, from
    # an offset drawn from the seed
    stride = traffic["logit_stride"]
    offset = int(np.random.default_rng([int(ctx.seed), 4]).integers(stride))
    units = traffic["trace_units"] if ctx.trace else None
    fed, kept_logits, events = [], {}, []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with Traced(ctx.trace, on_card) as tr:
        t_start = time.perf_counter()
        i = 0
        while i < traffic["free_slots"]:
            if on_card:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            fed.append(tok)
            with span("step call"):
                logits, caches = step(params, tok, caches, prompt + i)
            with span("greedy pick"):
                tok = logits[:, -1:].argmax(-1)
            if on_card:
                ev[1].record()
                events.append(ev)
            if i % stride == offset:
                kept_logits[i] = logits[:, -1].clone()
            i += 1
            if (i >= units) if units is not None else _end(ctx, t_start):
                break
        with span("sync"):
            if on_card:
                torch.cuda.synchronize()
        elapsed = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    step_ms = [a.elapsed_time(z) for a, z in events]
    wb = _weight_bytes(params)
    kept = {"kind": "decode", "ids": ids, "fed": fed,
            "served": fed[1:] + [tok], "logits": kept_logits,
            "caches": caches, "steps": i}
    del params, step, pre
    free_program()
    e2e = {"decode_tokens_per_s": b * i / elapsed, "setup_s": setup_s}
    if step_ms:
        e2e["decode_step_p95_ms"] = float(np.percentile(step_ms, 95))
    return Run(attempted=b * i, failed=0, e2e=e2e,
               work={"weight_bytes": wb, "batch": b, "prompt": prompt,
                     "steps": i},
               units=i, trace=tr.summary, memory_peak=peak, kept=kept)
