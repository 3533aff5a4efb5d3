#!/usr/bin/env python3
"""Sharded serving across cards: what tensor- and expert-parallel serving
costs and answers on real collectives.

``--cards`` processes, one card each, join one NCCL process group
(``tcp://localhost``, a free port).  For each ``--arch`` (at its published
widths, cut to ``--layers`` layers, weights from ``--seed`` on every card
alike) and each ``--meshes`` shape (data x model, its product the number
of cards), every rank:

- runs the unsharded builders on its own card (the whole model) as the
  reference: a check of ``CHECK_BATCH`` x ``CHECK_PROMPT`` tokens and
  ``CHECK_STEPS`` decode steps on fixed tokens in f32 compute, then the
  timed cell in bf16 (``--batch`` x ``--prompt``, ``--steps`` decode steps
  on fixed tokens, CUDA events after one warm-up prefill);
- runs the same through ``build_prefill_step``/``build_decode_step`` under
  ``make_rules(mesh)`` on ``shard_params`` of the same weights (the whole
  model freed first, so a card holds its shards only) and holds every
  stage's whole logits and every whole cache leaf of the f32 check against
  the reference within ``F32_TOL`` (fixed before the first run on cards;
  an expert choice that flips at a near tie of two gates would exceed it);
- reports the timed cell's prefill and median decode ms (the slowest
  rank's) and peak memory beside the reference's.

Rank 0 prints one JSON line per (arch, mesh) and a last line
``{"ok": ...}``; the exit code is 1 if a check failed.  The weights of
every card are checked equal first (a sum over every leaf).

    python3 tools/tp_serve_probe.py --cards 4 --meshes 1x4,2x2,4x1
    python3 tools/tp_serve_probe.py --cards 4 --arch phi3_medium_14b \\
        --meshes 1x4            # kv heads 10: the cache splits head_dim

``--device cpu --reduced`` runs the same on ``gloo`` with the reduced
configs (a rehearsal; times there are not device times).
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import pathlib
import socket
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CHECK_BATCH, CHECK_PROMPT, CHECK_STEPS = 2, 256, 4
F32_TOL = 1e-3       # abs, whole logits and cache leaves, f32 compute
TIMEOUT_S = 300      # a collective that waits longer fails the run


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).clone()


def _run(cfg, params, toks, steps, dtype, dev, rules=None,
         timed=False) -> dict:
    """Prefill ``toks[:, :-steps]`` then ``steps`` decode steps on the
    next tokens: whole logits of every stage and whole caches, or (timed)
    the times and peak memory."""
    import torch

    from repro_torch.models import init_cache
    from repro_torch.pytree import tree_leaves
    from repro_torch.train import build_decode_step, build_prefill_step
    prefill = build_prefill_step(cfg, rules)
    decode = build_decode_step(cfg, rules)
    b, n = toks.shape
    s = n - steps
    caches = init_cache(cfg, b, n, dtype=dtype, device=dev, rules=rules)
    on_card = dev.type == "cuda"

    def clock(fn):
        if not on_card:
            return fn(), 0.0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    if timed:
        prefill(params, {"tokens": toks[:, :s]}, caches)     # warm-up
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    (logits, caches), prefill_ms = clock(
        lambda: prefill(params, {"tokens": toks[:, :s]}, caches))
    seen = [] if timed else [_whole(logits)]
    step_ms = []
    for i in range(steps):
        (logits, caches), ms = clock(lambda: decode(
            params, toks[:, s + i:s + i + 1], caches, s + i))
        step_ms.append(ms)
        if not timed:
            seen.append(_whole(logits))
    if timed:
        return {"prefill_ms": prefill_ms,
                "decode_ms_median": statistics.median(step_ms),
                "peak_GB": (torch.cuda.max_memory_allocated() / 1e9
                            if on_card else 0.0)}
    return {"logits": seen, "caches": [_whole(t)
                                       for t in tree_leaves(caches)]}


def _max_err(got: list, want: list) -> float:
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def rank_main(rank, args, port):
    import gc
    from unittest import mock

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import make_batch
    from repro_torch.models import init_params, lm
    from repro_torch.models.params import shard_params
    from repro_torch.pytree import tree_leaves
    from repro_torch.sharding import make_rules

    on_card = args.device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=args.cards, device_id=dev if on_card else None,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    ok = True

    def report(rec):
        every = [None] * args.cards
        dist.all_gather_object(every, rec)
        return every

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    try:
        for arch in args.arch.split(","):
            base = (get_reduced if args.reduced else get_config)(arch)
            cfg = dataclasses.replace(base, n_layers=args.layers or
                                      base.n_layers)
            check = torch.from_numpy(make_batch(
                cfg, CHECK_BATCH, CHECK_PROMPT + CHECK_STEPS,
                seed=args.seed)["tokens"]).to(dev)
            toks = torch.from_numpy(make_batch(
                cfg, args.batch, args.prompt + args.steps, step=1,
                seed=args.seed)["tokens"]).to(dev)
            params = init_params(cfg, args.seed, device=dev)
            sums = report([float(t.double().sum()) for t in
                           tree_leaves(params)])
            if any(s != sums[0] for s in sums):
                raise RuntimeError(f"{arch}: the cards drew other weights")
            with mock.patch.object(lm, "COMPUTE_DTYPE", torch.float32):
                want = _run(cfg, params, check, CHECK_STEPS, torch.float32,
                            dev)
            base_t = _run(cfg, params, toks, args.steps, torch.bfloat16,
                          dev, timed=True)
            del params
            free()
            for shape in args.meshes.split(","):
                dims = tuple(int(x) for x in shape.split("x"))
                mesh = init_device_mesh(dev.type, dims,
                                        mesh_dim_names=("data", "model"))
                rules = make_rules(mesh)
                params = shard_params(init_params(cfg, args.seed,
                                                  device=dev), cfg, rules)
                free()
                held = sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree_leaves(params))
                with mock.patch.object(lm, "COMPUTE_DTYPE", torch.float32):
                    got = _run(cfg, params, check, CHECK_STEPS,
                               torch.float32, dev, rules)
                err = {"logits": _max_err(got["logits"], want["logits"]),
                       "caches": _max_err(got["caches"], want["caches"])}
                del got
                free()
                t = _run(cfg, params, toks, args.steps, torch.bfloat16, dev,
                         rules, timed=True)
                every = report({"err": err, "timed": t, "held_GB":
                                held / 1e9})
                del params
                free()
                passed = all(max(r["err"].values()) <= F32_TOL
                             for r in every)
                ok &= passed
                if rank == 0:
                    print(json.dumps({
                        "arch": cfg.name, "layers": cfg.n_layers,
                        "mesh": dict(rules.sizes), "cards": args.cards,
                        "batch": args.batch, "prompt": args.prompt,
                        "decode_steps": args.steps,
                        "f32_check": {
                            "batch": CHECK_BATCH, "prompt": CHECK_PROMPT,
                            "steps": CHECK_STEPS, "tol": F32_TOL,
                            "max_abs_err_by_rank": [r["err"] for r in every],
                            "passed": passed},
                        "sharded": {
                            "prefill_ms_max": max(r["timed"]["prefill_ms"]
                                                  for r in every),
                            "decode_ms_median_max": max(
                                r["timed"]["decode_ms_median"]
                                for r in every),
                            "peak_GB_max": max(r["timed"]["peak_GB"]
                                               for r in every),
                            "params_held_GB": every[0]["held_GB"]},
                        "unsharded_one_card": base_t}), flush=True)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"ok": ok}), flush=True)
    if not ok:
        sys.exit(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--meshes", default="1x4,2x2,4x1")
    ap.add_argument("--arch", default="qwen3_moe_235b_a22b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    for shape in args.meshes.split(","):
        d, m = (int(x) for x in shape.split("x"))
        if d * m != args.cards:
            raise SystemExit(f"mesh {shape} is not {args.cards} cards")
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < args.cards:
            raise SystemExit(f"{args.cards} cards asked for, "
                             f"{torch.cuda.device_count()} present")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    import torch.multiprocessing as mp
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    mp.start_processes(rank_main, args=(args, port), nprocs=args.cards,
                       start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
