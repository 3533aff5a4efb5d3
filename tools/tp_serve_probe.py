#!/usr/bin/env python3
"""Sharded serving across cards: what tensor- and expert-parallel serving
costs and answers on real collectives.

``--cards`` processes, one card each, join one NCCL process group
(``tcp://localhost``, a free port).  For each ``--arch`` (at its published
widths, cut to ``--layers`` layers, by default ``CUT``'s or all of them,
weights from ``--seed`` on every card alike) and each ``--meshes`` shape
(data x model, or pod x data x model over the JAX package's multi-pod
axes, its product the number of cards), every rank:

- runs the unsharded builders on its own card (the whole model) as the
  reference: a check of ``CHECK_BATCH`` x ``CHECK_PROMPT`` tokens and
  ``CHECK_STEPS`` decode steps on fixed tokens in f32 compute, then the
  timed cell in bf16 (``--batch`` x ``--prompt``, ``--steps`` decode steps
  on fixed tokens, CUDA events after one warm-up prefill); an
  encoder-decoder takes its ``make_batch`` frames and at most 448 text
  tokens (whisper's published context);
- runs the same through ``build_prefill_step``/``build_decode_step`` under
  ``make_rules(mesh)`` on ``shard_params`` of the same weights (the whole
  model freed first, so a card holds its shards only) and holds every
  stage's whole logits and every whole cache leaf of the f32 check against
  the reference within ``F32_TOL`` (fixed before the first run on cards;
  an expert choice that flips at a near tie of two gates would exceed it);
- reports the timed cell's prefill and median decode ms (the slowest
  rank's) and peak memory beside the reference's.

``--long`` serves the batch-1 long-context layout instead
(``make_rules(mesh, batch_divisible=False, seq_sharded_decode=True)``):
batch 1, caches of ``--max-seq`` slots split by ring slots over every
card, so each decode step combines the softmax across cards; the f32
check of a sliding-window config takes ``PAST_WINDOW`` tokens more than
its window (danube: 4608 against 4096 slots), so its ring wraps and every
card's stretch holds positions.

Rank 0 prints one JSON line per (arch, mesh) and a last line
``{"ok": ...}``; the exit code is 1 if a check failed.  The weights of
every card are checked equal first (a sum over every leaf).

    python3 tools/tp_serve_probe.py --cards 4 --meshes 1x4,2x2,4x1
    python3 tools/tp_serve_probe.py --cards 4 --meshes 2x2x1,2x1x2
    python3 tools/tp_serve_probe.py --cards 4 --arch phi3_medium_14b \\
        --meshes 1x4            # kv heads 10: the cache splits head_dim
    python3 tools/tp_serve_probe.py --cards 4 \\
        --arch rwkv6_1p6b,whisper_small,jamba_v01_52b
    python3 tools/tp_serve_probe.py --cards 4 --long \\
        --arch jamba_v01_52b,h2o_danube_1p8b

``--device cpu --reduced`` runs the same on ``gloo`` with the reduced
configs (a rehearsal; times there are not device times; with ``--long``
give a small ``--max-seq``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import sys

from probe_ranks import (checksum, clock, free, join, launch, mesh_axes,
                         mesh_shapes)
from probe_ranks import report as report_of

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CHECK_BATCH, CHECK_PROMPT, CHECK_STEPS = 2, 256, 4
PAST_WINDOW = 512    # --long: the f32 check's prompt past a window
F32_TOL = 1e-3       # abs, whole logits and cache leaves, f32 compute
TIMEOUT_S = 300      # a collective that waits longer fails the run
# default layers (else all).  rwkv6: deeper random stacks carry the f32
# reorder noise of a split contraction past F32_TOL (in the WKV state, on
# (1, 4): 7.2e-5 at 2 layers, 0.021 at 8, 1.9 at 24; PERF.md)
CUT = {"qwen3_moe_235b_a22b": 4, "phi3_medium_14b": 4, "jamba_v01_52b": 8,
       "rwkv6_1p6b": 2}
TEXT_CONTEXT = 448   # an encoder-decoder's text tokens at most


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).clone()


def _run(cfg, params, toks, steps, dtype, dev, rules=None, timed=False,
         extra=None, max_seq=None) -> dict:
    """Prefill ``toks[:, :-steps]`` (and ``extra``: an encoder-decoder's
    frames) then ``steps`` decode steps on the next tokens, on caches of
    ``max_seq`` slots (default: every token's): whole logits of every
    stage and whole caches, or (timed) the times and peak memory."""
    import torch

    from repro_torch.models import init_cache
    from repro_torch.train import build_decode_step, build_prefill_step
    prefill = build_prefill_step(cfg, rules)
    decode = build_decode_step(cfg, rules)
    b, n = toks.shape
    s = n - steps
    batch = {"tokens": toks[:, :s], **(extra or {})}

    def fresh():
        return init_cache(cfg, b, max_seq or n, dtype=dtype, device=dev,
                          rules=rules)

    on_card = dev.type == "cuda"

    if timed:
        prefill(params, batch, fresh())                      # warm-up
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    # fresh leaves: a prefill continues from the recurrent state it finds
    caches = fresh()
    (logits, caches), prefill_ms = clock(
        lambda: prefill(params, batch, caches), on_card)
    seen = [] if timed else [_whole(logits)]
    step_ms = []
    for i in range(steps):
        (logits, caches), ms = clock(lambda: decode(
            params, toks[:, s + i:s + i + 1], caches, s + i), on_card)
        step_ms.append(ms)
        if not timed:
            seen.append(_whole(logits))
    if timed:
        return {"prefill_ms": prefill_ms,
                "decode_ms_median": statistics.median(step_ms),
                "peak_GB": (torch.cuda.max_memory_allocated() / 1e9
                            if on_card else 0.0)}
    return {"logits": {f"stage {i}": t for i, t in enumerate(seen)},
            "caches": {f"{kind}/{name}": _whole(t)
                       for kind, leaves in caches.items()
                       for name, t in leaves.items()}}


def _errs(got: dict, want: dict) -> dict:
    """Per entry: the largest |got - want| and the largest |want|."""
    return {k: [float((got[k].float() - w.float()).abs().max()),
                float(w.float().abs().max())] for k, w in want.items()}


def rank_main(rank, args):
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

    dev = join(rank, args, TIMEOUT_S)
    on_card = dev.type == "cuda"
    ok = True

    def report(rec):
        return report_of(rec, args.cards)

    def inputs(cfg, batch, seq, step):
        b = make_batch(cfg, batch, seq, step=step, seed=args.seed)
        extra = ({"frames": torch.from_numpy(b["frames"]).to(dev)}
                 if cfg.is_encdec else {})
        return torch.from_numpy(b["tokens"]).to(dev), extra

    def rules_of(mesh):
        if args.long:
            return make_rules(mesh, batch_divisible=False,
                              seq_sharded_decode=True)
        return make_rules(mesh)

    try:
        for arch in args.arch.split(","):
            base = (get_reduced if args.reduced else get_config)(arch)
            layers = args.layers if args.layers is not None else CUT.get(
                arch, 0)
            cfg = dataclasses.replace(base, n_layers=layers or
                                      base.n_layers)
            batch = 1 if args.long else args.batch
            prompt = (min(args.prompt, TEXT_CONTEXT) if cfg.is_encdec
                      else args.prompt)
            check_prompt = (cfg.sliding_window + PAST_WINDOW
                            if args.long and cfg.sliding_window
                            else CHECK_PROMPT)
            check, cextra = inputs(cfg, 1 if args.long else CHECK_BATCH,
                                   check_prompt + CHECK_STEPS, 0)
            toks, extra = inputs(cfg, batch, prompt + args.steps, 1)
            kw = {"max_seq": args.max_seq} if args.long else {}
            params = init_params(cfg, args.seed, device=dev)
            sums = report([checksum(t) for t in tree_leaves(params)])
            if any(s != sums[0] for s in sums):
                raise RuntimeError(f"{arch}: the cards drew other weights")
            with mock.patch.object(lm, "COMPUTE_DTYPE", torch.float32):
                want = _run(cfg, params, check, CHECK_STEPS, torch.float32,
                            dev, extra=cextra, **kw)
            base_t = _run(cfg, params, toks, args.steps, torch.bfloat16,
                          dev, timed=True, extra=extra, **kw)
            del params
            free(on_card)
            for dims in mesh_shapes(args):
                mesh = init_device_mesh(dev.type, dims,
                                        mesh_dim_names=mesh_axes(dims))
                rules = rules_of(mesh)
                params = shard_params(init_params(cfg, args.seed,
                                                  device=dev), cfg, rules)
                free(on_card)
                held = sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree_leaves(params))
                with mock.patch.object(lm, "COMPUTE_DTYPE", torch.float32):
                    got = _run(cfg, params, check, CHECK_STEPS,
                               torch.float32, dev, rules, extra=cextra, **kw)
                by = {what: _errs(got[what], want[what])
                      for what in ("logits", "caches")}
                err = {what: max(e for e, _ in v.values())
                       for what, v in by.items()}
                del got
                free(on_card)
                t = _run(cfg, params, toks, args.steps, torch.bfloat16, dev,
                         rules, timed=True, extra=extra, **kw)
                every = report({"err": err, "by": by, "timed": t, "held_GB":
                                held / 1e9})
                del params
                free(on_card)
                passed = all(max(r["err"].values()) <= F32_TOL
                             for r in every)
                ok &= passed
                if rank == 0:
                    print(json.dumps({
                        "arch": cfg.name, "layers": cfg.n_layers,
                        "mesh": dict(rules.sizes), "cards": args.cards,
                        "long_context": args.long,
                        "max_seq": kw.get("max_seq"),
                        "batch": batch, "prompt": prompt,
                        "decode_steps": args.steps,
                        "f32_check": {
                            "batch": check.shape[0],
                            "prompt": check.shape[1] - CHECK_STEPS,
                            "steps": CHECK_STEPS, "tol": F32_TOL,
                            "max_abs_err_by_rank": [r["err"] for r in every],
                            # rank 0's [max |err|, max |reference|] by
                            # stage and by cache leaf
                            "rank0_err_and_largest": every[0]["by"],
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
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of each arch (0: all; default CUT's, "
                    "else all)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--long", action="store_true",
                    help="the batch-1 long-context layout")
    ap.add_argument("--max-seq", type=int, default=524288,
                    help="--long: cache slots")
    args = ap.parse_args()
    mesh_shapes(args)
    return launch(rank_main, args)


if __name__ == "__main__":
    sys.exit(main())
