"""Multi-pod dry run, without devices.

For every (architecture x input-shape) cell this describes the step
function (train_step / prefill / serve_step) on the production meshes:

    single-pod  (16, 16)        ("data", "model")        256 chips
    multi-pod   (2, 16, 16)     ("pod", "data", "model") 512 chips

and records per cell, in the JAX package's record (its ``run_cell``):

  * memory      — per-device argument, output and alias bytes, exact, from
                  ``train.input_specs``' specs (each leaf's shard);
  * cost        — per-device FLOPs of the products: the step run at the
                  global shapes on fake tensors (``FakeTensorMode``, which
                  allocates nothing) under ``FlopCounterMode``, divided by
                  the devices that share the work under the specs;
  * collectives — per-device bytes by collective type of the sharded
                  step (``train.build_train_step(..., rules=)``): from
                  the placements of the data-parallel scheme (serving,
                  ``dp_only`` and multi-pod train cells), and for the
                  single-pod train cells under the tensor-parallel rules
                  from the step's own collectives, counted by running one
                  microbatch of it on fake tensors at one rank's shapes
                  with a ``Shards`` that records each collective instead
                  of running it (``shards_collectives``);

into ``artifacts/dryrun_torch/<arch>__<shape>__<tag>.json``.  Figures that
only a compiler gives (temporaries, bytes accessed, code size, compile
times) are ``null``; the record's ``derived`` says how each figure was made.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo_1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod-only | --singlepod-only]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_config, shape_cells, train_settings
from ..optim import AdamWConfig
from ..pytree import tree_leaves
from ..sharding import make_rules, mesh_sizes
from ..sharding.collectives import Shards
from ..train import (build_decode_step, build_prefill_step, build_train_step,
                     input_specs)
from ..train.step import batch_axes
from .mesh import make_production_mesh

__all__ = ["run_cell", "main", "shard_bytes", "collective_bytes",
           "shards_collectives", "ART_DIR"]

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

DERIVED = {
    "argument_bytes": "sum over the step's inputs of each leaf's "
                      "per-device shard (shape / spec's axis sizes x dtype "
                      "size), from train.input_specs",
    "output_bytes": "the updated state or caches at their input specs, "
                    "plus the metrics (train) or the logits at "
                    "('act_batch', None, 'act_vocab') (prefill, decode)",
    "alias_bytes": "the donated input: the state (train) or the caches",
    "flops": "FlopCounterMode over the step at the global shapes on "
             "FakeTensorMode tensors (products only: mm, bmm, addmm, "
             "baddbmm), divided by the devices sharing the work: the "
             "product of the mesh axes of act_batch (the global batch's "
             "spec), of act_heads/act_mlp/act_experts and act_seq, and "
             "(decode) of cache_seq",
    "collectives": "bytes per device and collective type: an "
                   "all-gather counts its output, a reduce-scatter its "
                   "output shard, an all-reduce its tensor.  Serving and "
                   "dp_only train cells: the all-gather of every sharded "
                   "param leaf at use (its whole bytes); train also "
                   "reduces each gradient over the batch's mesh axes in "
                   "mesh order (reduce-scatter where the leaf is sharded "
                   "on the axis, else all-reduce) and all-reduces the "
                   "loss, token count and squared norm (4 bytes each).  "
                   "Single-pod train cells under the tensor-parallel "
                   "rules (the multi-pod mesh trains no tensor-parallel "
                   "step yet and keeps the data-parallel count): one "
                   "microbatch of the rank's rows through loss_fn and its "
                   "backward on FakeTensorMode tensors at rank 0's local "
                   "shapes, every collective of sharding.collectives "
                   "recorded (the per-layer gathers over 'data' at use, "
                   "again in remat's recompute, and their reduce-scatters; "
                   "the all-reduces over 'model' of each sum forward and "
                   "each enter backward; the router logits' gathers), "
                   "times accum; plus the all-reduce over 'data' of each "
                   "gradient replicated there (f32) and the loss, token "
                   "count and squared norm (4 bytes each)",
    "null": "temp_bytes, bytes_accessed, code_bytes, t_lower_s and "
            "t_compile_s need a compiler's analysis, which eager PyTorch "
            "does not have",
}


def shard_bytes(t, sizes: dict) -> int:
    """Per-device bytes of a stand-in from ``input_specs`` (its ``spec``
    over a mesh of ``sizes``)."""
    n = math.prod(t.shape)
    for axis in t.spec:
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                n //= sizes[a]
    return n * t.element_size()


def collective_bytes(specs: dict, rules, shape, settings: dict) -> dict:
    """Per-device bytes by collective type of the data-parallel scheme:
    the params gathered whole at use and, in a train step, each gradient
    summed over the mesh axes the batch is split over."""
    sizes = rules.sizes
    params = (specs["state"].params if shape.step == "train"
              else specs["params"])
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    for p in tree_leaves(params):
        if any(a is not None for a in p.spec):
            out["all-gather"] += math.prod(p.shape) * p.element_size()
    if shape.step == "train":
        axes = batch_axes(rules, shape.global_batch)
        accum = settings.get("accum", 1)
        gdt = getattr(torch, settings.get("accum_dtype", "float32"))
        for p in tree_leaves(params):
            local = math.prod(p.shape) * (gdt.itemsize if accum > 1
                                          else p.element_size())
            held = {a for ax in p.spec if ax is not None
                    for a in (ax if isinstance(ax, tuple) else (ax,))}
            for a in rules.mesh.mesh_dim_names:
                if a not in axes or sizes[a] == 1:
                    continue
                if a in held:
                    local //= sizes[a]
                    out["reduce-scatter"] += local
                else:
                    out["all-reduce"] += local
        out["all-reduce"] += 4 * (2 + (accum == 1))  # loss, norm, tokens
    return {k: v for k, v in out.items() if v}


class _Counting(Shards):
    """A ``Shards`` over a device-free mesh that runs no collective: each
    records its bytes by type (``bytes``) and returns a tensor of its
    result's shape, as rank 0 sees it.  ``data_dims`` gives each param
    leaf's dim over "data" (by ``id``), which ``at_use`` gathers."""

    def __init__(self, rules, batch: int, data_dims: dict):
        super().__init__(rules, batch, own_groups=True)
        self.data_dims = data_dims
        self.bytes = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}

    def rank(self, axis):
        return 0

    def _group(self, axis):
        return axis

    def _groups(self, axis):
        return [a for a in (axis if isinstance(axis, tuple) else (axis,))
                if self.size(a) > 1]

    def _all_reduce(self, t, op, groups):
        self.bytes["all-reduce"] += len(groups) * _nbytes(t)
        return t.clone()

    def _all_gather(self, t, group, n, dim):
        out = torch.cat([t] * n, dim=dim)
        self.bytes["all-gather"] += _nbytes(out)
        return out

    def _reduce_scatter(self, t, group, n, dim):
        out = t.narrow(dim, 0, t.shape[dim] // n).clone()
        self.bytes["reduce-scatter"] += _nbytes(out)
        return out

    def at_use(self, leaf, idx=None):
        local = leaf if idx is None else leaf[idx]
        dim = self.data_dims[id(leaf)]
        if dim is None or self.size("data") == 1:
            return local
        return self.gather_param(local, dim - (idx is not None))


def _nbytes(t) -> int:
    return math.prod(t.shape) * t.element_size()


def shards_collectives(cfg, rules, shape, settings: dict) -> dict:
    """Per-device bytes by collective type that ``sharding.collectives``
    moves in one tensor-parallel train step: one microbatch of a data
    rank's rows through ``loss_fn`` and its backward on ``FakeTensorMode``
    tensors at rank 0's local shapes, with a ``Shards`` that records each
    collective instead of running it, times ``accum``.  Every repeat of
    ``cfg.pattern`` moves the same bytes (its leaves' shapes are the same),
    so the step runs at one and two repeats and the difference is counted
    ``n_repeat - 1`` times more; also ``replicated_over_data``, the
    elements of the leaves that rest whole over "data"."""
    import dataclasses
    period = len(cfg.pattern)
    one, two = (_microbatch_bytes(dataclasses.replace(cfg, n_layers=k *
                                                      period),
                                  rules, shape, settings)
                for k in (1, 2))
    accum = settings.get("accum", 1)
    out = {k: accum * (one[k] + (cfg.n_repeat - 1) * (two[k] - one[k]))
           for k in one}
    specs = input_specs(cfg, shape, rules, settings)
    out["replicated_over_data"] = sum(
        math.prod(t.shape) for t in tree_leaves(specs["state"].params)
        if not any("data" in (a if isinstance(a, tuple) else (a,))
                   for a in t.spec))
    return out


def _microbatch_bytes(cfg, rules, shape, settings: dict) -> dict:
    """What ``shards_collectives`` records for one microbatch of ``cfg``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import loss_fn
    from ..pytree import tree_map
    specs = input_specs(cfg, shape, rules, settings)
    accum = settings.get("accum", 1)
    shards = math.prod(rules.sizes[a]
                       for a in batch_axes(rules, shape.global_batch))
    rows = shape.global_batch // shards // accum
    data_dims = {}

    def local(t):
        """Rank 0's shard of ``t`` (a stand-in with its spec), requiring
        a gradient; its dim over "data" noted for ``at_use``."""
        spec = tuple(t.spec) + (None,) * (len(t.shape) - len(t.spec))
        out = torch.empty(rules.local_shape(t.shape, spec), dtype=t.dtype,
                          device="cpu").requires_grad_()
        data_dims[id(out)] = next(
            (i for i, a in enumerate(spec)
             if "data" in (a if isinstance(a, tuple) else (a,))), None)
        return out

    with FakeTensorMode():
        params = tree_map(local, specs["state"].params)
        batch = tree_map(lambda t: torch.empty(
            (rows,) + tuple(t.shape[1:]), dtype=t.dtype, device="cpu"),
            specs["batch"])
        counting = _Counting(rules, shape.global_batch, data_dims)
        loss, _ = loss_fn(params, cfg, batch,
                          remat=settings.get("remat", "full"),
                          shards=counting)
        torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    return counting.bytes


def _tp_collectives(cfg, rules, shape, settings: dict) -> dict:
    """Per-device bytes by collective type of the tensor-parallel train
    step (``DERIVED["collectives"]``)."""
    out = shards_collectives(cfg, rules, shape, settings)
    n = out.pop("replicated_over_data")
    if any(rules.sizes[a] > 1 for a in batch_axes(rules,
                                                   shape.global_batch)):
        out["all-reduce"] += 4 * n   # their f32 gradients over "data"
    out["all-reduce"] += 4 * (2 + (settings.get("accum", 1) == 1))
    return {k: v for k, v in out.items() if v}


def _work_shards(rules, shape) -> int:
    """Devices that share the step's work under the specs."""
    axes = set(batch_axes(rules, shape.global_batch))
    names = ["act_heads", "act_mlp", "act_experts", "act_seq"]
    if shape.step == "decode":
        names.append("cache_seq")
    for e in (rules.table[n] for n in names):
        if e is not None:
            axes.update(e if isinstance(e, tuple) else (e,))
    return math.prod(rules.sizes[a] for a in axes)


def _fake_step(cfg, shape, specs: dict, settings: dict):
    """The step at the global shapes on fake tensors: (outputs, product
    FLOPs of the whole step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..pytree import tree_map

    with FakeTensorMode():
        fake = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="cpu"), specs)
        with FlopCounterMode(display=False) as fc:
            if shape.step == "train":
                opt_cfg = AdamWConfig(
                    mu_dtype=settings.get("mu_dtype", "float32"),
                    nu_dtype=settings.get("nu_dtype", "float32"))
                fn = build_train_step(
                    cfg, opt_cfg, accum=settings.get("accum", 1),
                    remat=settings.get("remat", "full"),
                    accum_dtype=getattr(torch, settings.get(
                        "accum_dtype", "float32")))
                out = fn(fake["state"], fake["batch"])
            elif shape.step == "prefill":
                out = build_prefill_step(cfg)(fake["params"], fake["batch"],
                                              fake["caches"])
            else:
                out = build_decode_step(cfg)(fake["params"], fake["token"],
                                             fake["caches"],
                                             shape.seq_len - 1)
    return out, fc.get_total_flops()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             save: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = mesh_sizes(mesh)
    settings = train_settings(arch) if shape.step == "train" else {}
    if multi_pod and settings.get("accum", 1) > 1:
        # 2x the DP shards on the multi-pod mesh: halve accumulation so
        # per-shard microbatches stay integral
        settings = dict(settings, accum=max(1, settings["accum"] // 2))
    rules = make_rules(
        mesh,
        batch_divisible=(shape.global_batch %
                         (sizes.get("pod", 1) * sizes["data"]) == 0),
        seq_sharded_decode=(shape.step == "decode"),
        seq_parallel=settings.get("seq_parallel", False),
        dp_only=settings.get("dp_only", False),
    )
    specs = input_specs(cfg, shape, rules, settings)
    out, flops = _fake_step(cfg, shape, specs, settings)

    donated = specs["state"] if shape.step == "train" else specs["caches"]
    alias = sum(shard_bytes(t, sizes) for t in tree_leaves(donated))
    if shape.step == "train":
        extra = sum(v.element_size() for v in out[1].values())   # 0-d
    else:
        logits = out[0]
        spec = rules.spec(("act_batch", None, "act_vocab"), logits.shape)
        stand = torch.empty(logits.shape, dtype=logits.dtype, device="meta")
        stand.spec = spec
        extra = shard_bytes(stand, sizes)
    work = _work_shards(rules, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(mesh.shape),
        "axes": list(mesh.mesh_dim_names),
        "step": shape.step,
        "n_devices": int(mesh.size()),
        "memory": {
            "argument_bytes": sum(shard_bytes(t, sizes)
                                  for t in tree_leaves(specs)),
            "output_bytes": alias + extra,
            "temp_bytes": None,
            "alias_bytes": alias,
            "code_bytes": None,
        },
        "cost": {
            "flops": flops / work,
            "bytes_accessed": None,
        },
        "collectives": (_tp_collectives(cfg, rules, shape, settings)
                        if shape.step == "train" and not multi_pod
                        and not rules.table["_gather_tp"]
                        else collective_bytes(specs, rules, shape, settings)),
        "settings": settings,
        "t_lower_s": None,
        "t_compile_s": None,
        "params_est": cfg.n_params(),
        "params_active_est": cfg.n_active_params(),
        "derived": dict(DERIVED, work_shards=work, flops_total=flops),
    }
    if save:
        os.makedirs(ART_DIR, exist_ok=True)
        tag = "multipod" if multi_pod else "singlepod"
        path = os.path.join(ART_DIR, f"{arch}__{shape_name}__{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--singlepod-only", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in shape_cells(arch):
                cells.append((arch, shape.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True]
    if args.multipod_only:
        meshes = [True]
    if args.singlepod_only:
        meshes = [False]

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = "multipod" if mp else "singlepod"
            path = os.path.join(ART_DIR, f"{arch}__{shape}__{tag}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {arch} x {shape} x {tag}")
                continue
            try:
                t0 = time.perf_counter()
                rec = run_cell(arch, shape, multi_pod=mp)
                gb = rec["memory"]["argument_bytes"] / 2**30
                print(f"[ok]   {arch} x {shape} x {tag}: "
                      f"{gb:.2f} GiB/dev of arguments, "
                      f"{rec['cost']['flops']/1e9:.1f} GFLOP/dev, "
                      f"{time.perf_counter() - t0:.1f} s")
            except Exception as e:      # report the cell, go on to the next
                failures += 1
                print(f"[FAIL] {arch} x {shape} x {tag}: {e}")
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
