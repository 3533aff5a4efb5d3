"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, run its driver (by the traffic file's ``kind``), check
what the timed path produced against the reference, read the per-layer
metrics and print the result line.

Files found by name:

- ``bench/configs/<config>.json``: the configuration as run;
- ``bench/traffic/<traffic>.json``: the traffic mix's parameters and its
  ``kind`` (``prefill``, ``decode`` or ``train``);
- ``bench/limits/<workload>.json``: each compared number's limit;
- ``bench/reference/<model_type>.py``: the configuration's plain
  reference (``spec(conf)`` and the model's functions);
- ``bench/metrics/<metric>.py``: the reader of one per-layer metric,
  ``read(rec)``: a number, a dict with ``"value"`` and notes, or None
  where the run has nothing for it.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level modules that no run may load (compared whole)
BARRED = ("jax", "jaxlib", "flax", "repro", "benchmarks")

__all__ = ["Ctx", "load_cell", "barred_modules", "run_cell", "main"]


@dataclasses.dataclass
class Ctx:
    workload: str
    seed: int
    seconds: float
    trace: bool
    t0: float
    manifest: dict
    cell: dict
    conf: dict
    traffic: dict
    limits: dict
    device: object = None
    cfg: object = None            # the port's ModelConfig
    ref: object = None            # the reference's module (model_type)
    spec: object = None           # the reference's sizes
    ref_shapes: dict = None
    variant: str | None = None    # "compress": the program's int8 path
    card: str = ""
    marks: dict = dataclasses.field(default_factory=dict)
    # a cell of several cards: this rank's ``Rules`` over the mesh of the
    # configuration's ``run.mesh``, its rank, the ranks and the ``gloo``
    # group of the host's decisions (None: the default group)
    rules: object = None
    rank: int = 0
    world: int = 1
    host: object = None

    def mark(self, name: str) -> None:
        """Seconds from process start to ``name`` (set-up's parts)."""
        self.marks[name] = time.perf_counter() - self.t0


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, manifest: dict | None = None) -> tuple:
    """(manifest, cell, config file, traffic file, limits) of
    ``workload``."""
    manifest = manifest or _json(ROOT / "BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf_entry = next(c for c in manifest["configs"]
                      if c["name"] == cell["config"])
    return (manifest, cell, _json(ROOT / conf_entry["file"]),
            _json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            _json(BENCH / "limits" / f"{workload}.json"))


def barred_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BARRED)


def _reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _layer_metrics(ctx: Ctx) -> list:
    """The per-layer metrics this cell reports: those that list it (every
    per-layer metric of this benchmark names its cells)."""
    return [m for m in ctx.manifest["per_layer"]
            if ctx.workload in m["workloads"]]


def _e2e(ctx: Ctx) -> list:
    return [m for m in ctx.manifest["end_to_end"]
            if ctx.workload in m.get("workloads", [ctx.workload])]


def _decode_work(ctx: Ctx, run, extra: dict) -> dict:
    from .work import Sizes, lm_work
    w = run.work
    total = {"bf16_ops": 0, "f32_ops": 0, "bytes": 0}
    read = round(extra["experts_read_per_step"]) if ctx.spec.experts else None
    for j in range(run.units):
        one = lm_work(Sizes.of(ctx.cfg), w["weight_bytes"], w["batch"], 1,
                      w["prompt"] + j + 1, read)
        for k in total:
            total[k] += one[k]
    return total


def run_cell(ctx: Ctx, *, control: bool = False) -> dict:
    """Run the cell once on ``ctx.device`` and return the result line's
    object (``control`` also reads the control's numbers, under
    ``"control"``; the benchmark's own runs never do)."""
    from . import check, program, serve, train
    from .work import peaks

    if ctx.cell["chips"] != ctx.world:
        # each card is a rank of its own (``bench.ranks``): a cell never
        # runs on fewer cards than it reports
        raise SystemExit(f"bench: {ctx.workload} asks for "
                         f"{ctx.cell['chips']} cards; this run has "
                         f"{ctx.world} ranks")
    if ctx.world > 1 and ctx.traffic["kind"] != "prefill":
        raise SystemExit(f"bench: no driver runs {ctx.traffic['kind']} on "
                         "several cards")
    if ctx.world > 1 and math.prod(ctx.rules.sizes.values()) != ctx.world:
        raise SystemExit(f"bench: the mesh {ctx.rules.sizes} is not "
                         f"{ctx.world} cards")
    ctx.mark("imports")
    ctx.cfg = program.port_config(ctx.conf)
    ctx.ref = importlib.import_module(
        f"bench.reference.{ctx.conf['model_type']}")
    ctx.spec = ctx.ref.spec(ctx.conf)
    ctx.ref_shapes = ctx.ref.leaf_shapes(ctx.spec)
    kind = ctx.traffic["kind"]
    driver = {"prefill": serve.prefill, "decode": serve.decode,
              "train": train.train}[kind]
    run = driver(ctx)
    extra = {}
    if kind == "train":
        want = check.train_reference(ctx, ctx.traffic["setup_steps"])
        numbers = {"program": check.train_numbers(run.kept, want)}
    else:
        numbers, extra = check.serving_numbers(ctx, run.kept, control)
    if kind == "decode":
        run.work = _decode_work(ctx, run, extra)
    correct, checks = check.verdict(numbers["program"], ctx.limits)

    on_card = ctx.device.type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu", "kind": ctx.card,
              "count": ctx.cell["chips"], "memory_peak_bytes": run.memory_peak}
    units = {m["name"]: m["unit"] for m in ctx.manifest["end_to_end"]}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed}
    if ctx.trace:
        flops, bw = peaks(ctx.card) if on_card else (float("nan"),) * 2
        # what a per-layer reader may read: the window's work and the
        # trace's numbers, with the cell's configuration and traffic
        rec = {"kind": kind, "work": run.work, "units": run.units,
               "chips": ctx.cell["chips"], "flops": flops, "bw": bw,
               "conf": ctx.conf, "traffic": ctx.traffic, "cfg": ctx.cfg,
               **(run.trace or {})}
        metrics = {}
        for m in _layer_metrics(ctx):
            value = _reader(m["name"])(rec)
            if value is None:
                continue
            entry = value if isinstance(value, dict) else {"value": value}
            metrics[m["name"]] = {"value": entry["value"], "unit": m["unit"],
                                  **{k: v for k, v in entry.items()
                                     if k != "value"}}
        out["metrics"] = metrics
        if run.trace:
            device.update(busy_s=run.trace["busy_s"],
                          window_s=run.trace["window_s"])
            out["breakdown"] = {k: run.trace[k]
                                for k in ("device_ops", "idle_gaps")}
    else:
        out["metrics"] = {m["name"]: {"value": run.e2e[m["name"]],
                                      "unit": units[m["name"]]}
                          for m in _e2e(ctx) if m["name"] in run.e2e}
    out["device"] = device
    if control:
        out["numbers"] = numbers["program"]
        out["control"] = numbers.get("control")
    out["checks"] = checks
    barred = barred_modules()
    if barred:
        raise SystemExit(f"modules loaded that no run may load: {barred}")
    return out


def _power_limit_w() -> float | None:
    """The card's power limit (``nvidia-smi``), printed beside every
    number: a card set below 700 W runs slower under load."""
    import subprocess
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def mesh_rules(conf: dict, device_type: str):
    """``make_rules`` over a ``DeviceMesh`` of the configuration's
    ``run.mesh`` (axis name -> size, in mesh order), in the process group
    this rank has joined."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import make_rules
    dims = conf["run"]["mesh"]
    mesh = init_device_mesh(device_type, tuple(dims.values()),
                            mesh_dim_names=tuple(dims))
    return make_rules(mesh)


def rank_run(rank: int, world: int, dev, host, payload):
    """One rank of a cell of several cards (``bench.ranks.launch``'s
    target): (result, set-up marks) on rank 0, None on the others."""
    import torch
    args, t0 = payload
    manifest, cell, conf, traffic, limits = load_cell(args.workload)
    ctx = Ctx(workload=args.workload, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), t0=t0, manifest=manifest, cell=cell,
              conf=conf, traffic=traffic, limits=limits, device=dev,
              card=torch.cuda.get_device_name(dev),
              rules=mesh_rules(conf, dev.type), rank=rank, world=world,
              host=host)
    ctx.mark("cuda")
    out = run_cell(ctx)
    return (out, ctx.marks) if rank == 0 else None


def main(args, t0: float) -> int:
    import torch
    manifest, cell, conf, traffic, limits = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if cell["chips"] == 1:      # in this process: no spawn, no group
        ctx = Ctx(workload=args.workload, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), t0=t0,
                  manifest=manifest, cell=cell, conf=conf, traffic=traffic,
                  limits=limits, device=torch.device("cuda", 0),
                  card=torch.cuda.get_device_name(0))
        torch.cuda.set_device(0)
        ctx.mark("cuda")
        out, marks = run_cell(ctx), ctx.marks
    else:
        from .ranks import RankFailure, launch
        try:
            out, marks = launch(cell["chips"], "cuda", rank_run, (args, t0))
        except RankFailure as e:
            print(f"bench: {e}; no result", file=sys.stderr)
            return 1
    barred = barred_modules()
    if barred:
        print(f"bench: modules loaded that no run may load: {barred}",
              file=sys.stderr)
        return 1
    out["device"]["power_limit_w"] = _power_limit_w()
    print("set-up marks (s from start): " + ", ".join(
        f"{k} {v:.2f}" for k, v in marks.items()), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
