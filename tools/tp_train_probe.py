#!/usr/bin/env python3
"""The tensor-parallel train step across cards: what it costs and what it
computes when the collectives' backwards run on NCCL.

``--cards`` processes, one card each, join one NCCL process group
(``tcp://localhost``, a free port).  For each ``--arch`` (its published
widths; ``--layers`` layers, by default ``CUT``'s or all of them; params
and moments in the dtypes of its ``TRAIN_SETTINGS``; weights from
``--seed`` on every card alike) and each ``--meshes`` shape (data x model,
or pod x data x model over the JAX package's multi-pod axes, its product
the number of cards):

- a check at ``CHECK_LAYERS`` layers (fewer where the arch has fewer),
  ``CHECK_BATCH`` x ``CHECK_SEQ`` tokens, f32 compute: rank 0 runs the
  unsharded gradient and step on its own card with one microbatch, as
  the sharded step (the reference's step: its microbatch's loss and MoE
  token groups are the whole microbatch's, wherever its rows lie), and
  keeps them on its host; then every rank runs ``train.sharded_grads``
  and one step of ``build_train_step(..., rules=make_rules(mesh))`` from
  the same state, and rank 0 holds the loss, every gradient leaf and
  every param, ``mu`` and ``nu`` leaf after the step, each gathered whole
  and compared as it comes, within the tolerances below (four hosts'
  copies of a 3.7 B-param state and its gradient exceed the machine's
  memory);
- every rank times the cell in bf16 at ``--layers``: ``--batch`` x
  ``--seq`` tokens, the settings' accumulation (at most the rows over
  the batch shards, so each microbatch splits over them), ``remat=
  "full"``, one warm-up then ``--timed`` steps with CUDA
  events, on one card unsharded and then sharded, with the peak memory
  and the state a card holds; ``--timed 0`` runs the checks only.

Tolerances of the check (fixed before the first run on cards): the loss
within ``LOSS_RTOL`` relative; each gradient leaf within ``GRAD_TOL`` of
its largest |g| (f32 leaves; ``GRAD_TOL_BF16`` where the params are bf16
and so are their gradients); ``mu`` within the gradient tolerance and
``nu`` within twice it of the leaf's largest value; each param within
``lr`` times the largest change of AdamW's first update ``g / (|g| +
eps)`` over the gradient's tolerance interval ``[g - dg, g + dg]`` (2
where the interval holds zero: a bf16 gradient summed from rounded parts
can change its sign there), plus 1e-4 of the leaf's largest update, 1e-6
of the param and one unit in the last place of the param's dtype.

Rank 0 prints one JSON line per (arch, mesh) and a last line
``{"ok": ...}``; the exit code is 1 if a check failed.  The weights of
every card are checked equal first (a sum over every leaf).

    python3 tools/tp_train_probe.py --cards 4 --meshes 1x4,2x2,4x1 \\
        --arch paligemma_3b,qwen3_moe_235b_a22b
    python3 tools/tp_train_probe.py --cards 4 --meshes 2x2x1,2x1x2

``--device cpu --reduced`` runs the same on ``gloo`` with the reduced
configs (a rehearsal; times there are not device times).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import sys

from probe_ranks import (batch_shards, checksum, clock, free, join, launch,
                         mesh_axes, mesh_shapes)
from probe_ranks import report as report_of

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CHECK_LAYERS = 2
CHECK_BATCH, CHECK_SEQ = 4, 512      # paligemma: 256 patches, 256 text
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
GRAD_TOL_BF16 = 2.0 ** -6
TIMEOUT_S = 600      # a collective that waits longer fails the run
# default layers (else all): qwen3-moe's 94 layers of 128 experts do not
# fit one card's state; one layer holds every expert of a layer
CUT = {"qwen3_moe_235b_a22b": 1}
OPT = dict(warmup_steps=5, total_steps=30)       # chip_smoke's TRAIN_OPT


def _host(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).cpu()


def _state(cfg, settings, seed, dev, rules=None):
    """A fresh state in the settings' dtypes; with ``rules``, its shards."""
    import torch

    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.pytree import tree_map
    from repro_torch.train import TrainState, init_train_state, shard_state
    opt = AdamWConfig(**OPT, mu_dtype=settings.get("mu_dtype", "float32"),
                      nu_dtype=settings.get("nu_dtype", "float32"))
    dt = getattr(torch, settings.get("param_dtype", "float32"))
    state = init_train_state(cfg, seed, opt_cfg=opt, device=dev)
    if dt != torch.float32:
        params = tree_map(lambda p: p.to(dt), state.params)
        state = TrainState(params, adamw_init(params, opt), None)
    return opt, (state if rules is None else shard_state(state, cfg, rules))


def _errs(got: list, want: list) -> list:
    """Per leaf: the largest |got - want| over the largest |want|."""
    out = []
    for a, b in zip(got, want):
        top = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        out.append(err / top if top else err)
    return out


def tol_of(leaf) -> float:
    """The gradient tolerance of a state whose params are ``leaf``'s
    dtype."""
    import torch
    return GRAD_TOL_BF16 if leaf.dtype == torch.bfloat16 else GRAD_TOL


def _params_held(got, want, old, mu, lr, tol) -> bool:
    """The params within the module docstring's bound for AdamW's first
    step, ``mu`` the reference's first moment."""
    import torch
    eps, b1 = 1e-8, 0.9
    g = mu.double().abs() / (1 - b1)
    dg = tol * float(g.max())
    near = torch.clamp(g - dg, min=0.0)        # |g| nearest zero
    du = torch.where(g <= dg, 2.0,
                     torch.clamp(eps * dg / (near + eps) ** 2, max=2.0))
    ulp = torch.finfo(want.dtype).eps * want.double().abs()
    bound = (lr * du + 1e-4 * float((want.double() - old.double()).abs()
                                    .max())
             + 1e-6 * want.double().abs() + ulp)
    return bool(((got.double() - want.double()).abs() <= bound).all())


def rank_main(rank, args):
    from unittest import mock

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, get_reduced, train_settings
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.pytree import tree_leaves
    from repro_torch.sharding import make_rules
    from repro_torch.train import (accumulate_grads, build_train_step,
                                   sharded_grads)

    dev = join(rank, args, TIMEOUT_S)
    on_card = dev.type == "cuda"
    ok = True

    def report(rec):
        return report_of(rec, args.cards)

    def batch_of(cfg, b, seq):
        return {k: torch.from_numpy(v).to(dev) for k, v in TokenPipeline(
            cfg, b, seq, seed=args.seed).batch_at(0).items()}

    def check(cfg, settings, rules):
        """The f32 check on ``rules``' mesh: rank 0's own unsharded
        gradient and step, one microbatch, kept on its host, against the
        sharded ones, each leaf gathered whole and compared as it comes
        (the other ranks return None)."""
        batch = batch_of(cfg, CHECK_BATCH, CHECK_SEQ)
        with mock.patch.object(lm, "COMPUTE_DTYPE", torch.float32):
            opt, state = _state(cfg, settings, args.seed, dev)
            sums = report([checksum(t) for t in tree_leaves(state.params)])
            if any(s != sums[0] for s in sums):
                raise RuntimeError(f"{cfg.name}: the cards drew other "
                                   "weights")
            if rank == 0:
                old = [t.cpu() for t in tree_leaves(state.params)]
                grads, _ = accumulate_grads(cfg, state.params, batch)
                want_g = [t.cpu() for t in tree_leaves(grads)]
                del grads
                new, want_m = build_train_step(cfg, opt)(state, batch)
                want = [t.cpu() for t in tree_leaves(new)]
                del new
            del state
            free(on_card)
            _, state = _state(cfg, settings, args.seed, dev, rules)
            grads, _ = sharded_grads(cfg, state.params, batch, rules)
            got_g = [_host(t) for t in tree_leaves(grads)]
            g_errs = _errs(got_g, want_g) if rank == 0 else None
            del grads, got_g
            new, got_m = build_train_step(cfg, opt, rules=rules)(state,
                                                                  batch)
            del state
            n = len(tree_leaves(new.params))
            errs, held = [], True
            for i, t in enumerate(tree_leaves(new)):
                t = _host(t)                 # every rank joins the gather
                if rank == 0 and i < 3 * n:
                    errs.append(_errs([t], [want[i]])[0])
                    if i < n:
                        held &= _params_held(t, want[i], old[i],
                                             want[n + i],
                                             float(want_m["lr"]), tol_of(
                                                 old[0]))
            del new
            free(on_card)
        if rank != 0:
            return None
        tol = tol_of(old[0])
        out = {"loss": [float(got_m["loss"]), float(want_m["loss"])],
               "grad_norm": [float(got_m["grad_norm"]),
                             float(want_m["grad_norm"])],
               "grads_worst": max(g_errs),
               "mu_worst": max(errs[n:2 * n]),
               "nu_worst": max(errs[2 * n:3 * n]),
               "params_held": held}
        loss_ok = abs(out["loss"][0] - out["loss"][1]) <= (
            LOSS_RTOL * abs(out["loss"][1]))
        out["passed"] = bool(
            loss_ok and out["grads_worst"] <= tol
            and out["mu_worst"] <= tol and out["nu_worst"] <= 2 * tol
            and out["params_held"])
        out["tol"] = {"loss_rtol": LOSS_RTOL, "grad": tol}
        return out

    def timed(cfg, settings, rules, accum: int) -> dict:
        """``--timed`` bf16 steps after one warm-up: ms each, the peak."""
        batch = batch_of(cfg, args.batch, args.seq)
        opt, state = _state(cfg, settings, args.seed, dev, rules)
        held = sum(t.to_local().numel() * t.to_local().element_size()
                   if hasattr(t, "to_local") else t.numel() * t.element_size()
                   for t in tree_leaves((state.params, state.opt.mu,
                                         state.opt.nu)))
        step = build_train_step(cfg, opt, rules=rules, accum=accum,
                                remat="full", accum_dtype=getattr(
                                    torch, settings.get("accum_dtype",
                                                        "float32")))
        state, _ = step(state, batch)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(args.timed):
            (state, m), ms = clock(lambda: step(state, batch), on_card)
            times.append(ms)
            losses.append(float(m["loss"]))
        del state
        free(on_card)
        return {"accum": accum, "step_ms": times,
                "step_ms_median": statistics.median(times),
                "tokens_per_s": (args.batch * args.seq
                                 / statistics.median(times) * 1e3
                                 if on_card else 0.0),
                "peak_GB": (torch.cuda.max_memory_allocated() / 1e9
                            if on_card else 0.0),
                "state_held_GB": held / 1e9, "losses": losses}

    try:
        for arch in args.arch.split(","):
            base = (get_reduced if args.reduced else get_config)(arch)
            settings = train_settings(arch)
            layers = args.layers if args.layers is not None else CUT.get(
                arch, 0)
            cfg = dataclasses.replace(base, n_layers=layers or
                                      base.n_layers)
            small = dataclasses.replace(
                base, n_layers=min(CHECK_LAYERS, cfg.n_layers))
            rows = args.batch
            one = (timed(cfg, settings, None,
                         min(settings.get("accum", 1), rows))
                   if args.timed else None)
            for dims in mesh_shapes(args):
                mesh = init_device_mesh(dev.type, dims,
                                        mesh_dim_names=mesh_axes(dims))
                rules = make_rules(mesh)
                res = check(small, settings, rules)
                t = (timed(cfg, settings, rules,
                           min(settings.get("accum", 1),
                               rows // batch_shards(dims)))
                     if args.timed else None)
                every = report({"check": res, "timed": t})
                passed = every[0]["check"]["passed"]
                ok &= passed
                if rank == 0:
                    print(json.dumps({
                        "arch": cfg.name, "layers": cfg.n_layers,
                        "mesh": dict(rules.sizes), "cards": args.cards,
                        "settings": settings, "batch": args.batch,
                        "seq": args.seq,
                        "f32_check": {
                            "layers": small.n_layers, "batch": CHECK_BATCH,
                            "seq": CHECK_SEQ, "microbatches": 1,
                            "rank0": every[0]["check"], "passed": passed},
                        "sharded": t and {
                            "accum": t["accum"],
                            "step_ms_median_max": max(
                                r["timed"]["step_ms_median"] for r in every),
                            "tokens_per_s_min": min(
                                r["timed"]["tokens_per_s"] for r in every),
                            "peak_GB_max": max(r["timed"]["peak_GB"]
                                               for r in every),
                            "state_held_GB": every[0]["timed"][
                                "state_held_GB"],
                            "rank0": t},
                        "unsharded_one_card": one}), flush=True)
                free(on_card)
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
    ap.add_argument("--arch", default="paligemma_3b,qwen3_moe_235b_a22b")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of each arch (0: all; default CUT's, "
                    "else all)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--timed", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    for dims in mesh_shapes(args):
        d = batch_shards(dims)
        if args.batch % d or CHECK_BATCH % d:
            raise SystemExit(f"mesh {'x'.join(map(str, dims))}: the batch "
                             "does not split over its batch shards")
    # segments that grow: the one-card step of paligemma-3b (old and new
    # state, 60 GB) does not fit among fixed-size freed blocks
    return launch(rank_main, args,
                  PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")


if __name__ == "__main__":
    sys.exit(main())
