"""Training driver: the port's ``build_train_step`` on its own state, fed
packed documents from the seed.  Set-up builds the one step object and
the one state, drives them through the first ``setup_steps`` steps (the
window's own call and feed, rows that all differ) and records what the
check compares: each step's loss, each leaf's first gradient as the
optimizer got it (from the first moment after one step), and each leaf's
change after the set-up steps.  The same step and state then run the
window.
"""
from __future__ import annotations

import time

import torch

from . import generate
from .program import port_params, tree_leaves
from .serve import Run, free_program
from .trace import Traced, span
from .work import Sizes, train_work

__all__ = ["train"]


def _norms(tree, scale: float = 1.0) -> dict:
    return {(name, layer): float(t.float().norm()) * scale
            for name, layer, t in tree_leaves(tree)}


def train(ctx) -> Run:
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.compress import ef_init
    from repro_torch.train import TrainState, build_train_step
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    run = ctx.conf["run"]
    on_card = dev.type == "cuda"
    opt = AdamWConfig(**run["optimizer"])
    params = port_params(cfg, ctx.conf, ctx.ref_shapes, ctx.seed, dev)
    ctx.mark("weights")
    n_params = sum(t.numel() for _, _, t in tree_leaves(params))
    compress = ctx.variant == "compress"        # the int8 control
    state = TrainState(params=params, opt=adamw_init(params, opt),
                       ef=ef_init(params) if compress else None)
    step = build_train_step(cfg, opt, remat=run["remat"], compress=compress)
    sep = ctx.conf[traffic["separator"]]

    def feed(i):
        with span("make inputs"):
            b = generate.train_batch(traffic, ctx.seed, i, cfg.vocab_size,
                                     sep)
            return {k: torch.from_numpy(v).to(dev, non_blocking=True)
                    for k, v in b.items()}

    losses, grads = [], None
    for i in range(traffic["setup_steps"]):
        state, m = step(state, feed(i))
        losses.append(float(m["loss"]))
        if i == 0:
            grads = _norms(state.opt.mu, 1.0 / (1.0 - opt.b1))
    p_now = dict(((n, l), t) for n, l, t in tree_leaves(state.params))
    change = {(n, l): float((p_now[(n, l)].float() - t.float()).norm())
              for n, l, t in tree_leaves(params)}
    del params, p_now
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0

    units = traffic["trace_units"] if ctx.trace else None
    window_losses = []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with Traced(ctx.trace, dev.type == "cuda") as tr:
        t_start = time.perf_counter()
        i = 0
        while True:
            batch = feed(traffic["setup_steps"] + i)
            with span("step call"):
                state, m = step(state, batch)
            window_losses.append(m["loss"])
            i += 1
            if ((i >= units) if units is not None
                    else time.perf_counter() - t_start >= ctx.seconds):
                break
        with span("sync"):
            if on_card:
                torch.cuda.synchronize()
        elapsed = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = int(sum(1 for x in window_losses if not torch.isfinite(x)))
    b, s = traffic["batch"], traffic["seq"]
    w = train_work(Sizes.of(cfg), b, s, n_params)
    del state, step, window_losses
    free_program()
    return Run(attempted=i, failed=failed,
               e2e={"train_tokens_per_s": b * s * i / elapsed,
                    "setup_s": setup_s},
               work={k: v * i for k, v in w.items()}, units=i,
               trace=tr.summary, memory_peak=peak,
               kept={"kind": "train", "losses": losses, "grads": grads,
                     "change": change, "opt": opt})
