#!/usr/bin/env python3
"""The readings the limits of ``bench/limits/<workload>.json`` are set
from, on the card(s) at the cell's own size: for each seed, one run of the
cell with a short window and the numbers its check compares, for the
program and, with ``--control``, for the control (serving: the reference
with float8 operands put in the program's place; training: the program's
own int8 path, ``compress``).  ``--fault`` plants a fault in the program
instead (``bench/faults.py``): ``half``, the step's gradient over the
first half of the batch; ``rank_partial``, one rank's experts' partial
left out of the MoE combine's all-reduce (a cell of several cards, which
runs one process a card through ``bench/ranks.py``, each seed in the same
processes).  One JSON line a seed, also appended to ``--out``:

    python3 bench/calibrate.py --workload qwen3moe-l4.prefill-mix \\
        --seeds 11,12,13 --seconds 3 --control

The benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from bench.run import _environment  # noqa: E402

__all__ = ["readings", "main"]


def _ctx(p: dict, seed: int, dev, rank: int, world: int, host,
         variant=None):
    import torch

    from bench.harness import Ctx, load_cell, mesh_rules
    from bench.small import small_ctx
    if p["small"]:
        ctx = small_ctx(p["workload"], seed, p["seconds"],
                        trace=p.get("trace", False), variant=variant)
    else:
        manifest, cell, conf, traffic, limits = load_cell(p["workload"])
        ctx = Ctx(workload=p["workload"], seed=seed, seconds=p["seconds"],
                  trace=False, t0=time.perf_counter(), manifest=manifest,
                  cell=cell, conf=conf, traffic=traffic, limits=limits,
                  device=dev, variant=variant,
                  card=torch.cuda.get_device_name(dev))
    ctx.device, ctx.rank, ctx.world, ctx.host = dev, rank, world, host
    if world > 1:
        ctx.rules = mesh_rules(ctx.conf, dev.type)
    return ctx


def readings(rank: int, world: int, dev, host, p: dict) -> list:
    """One record a seed of ``p["seeds"]`` (rank 0's; every rank runs
    each seed): the numbers compared for the program, the control or the
    fault ``p["fault"]``, and the run's metrics and peak.  ``p["small"]``:
    at the files' ``test_sizes`` (a CPU rehearsal).  Also
    ``bench.ranks.launch``'s target."""
    import gc

    import torch

    from bench.faults import FAULTS
    from bench.harness import run_cell
    recs = []
    for seed in p["seeds"]:
        ctx = _ctx(p, seed, dev, rank, world, host)
        train = ctx.traffic["kind"] == "train"
        rec = {"workload": p["workload"], "seed": seed}
        if p["fault"]:
            with FAULTS[p["fault"]]():
                out = run_cell(ctx)
            rec["fault_" + p["fault"]] = {k: v["value"] for k, v in
                                          out["checks"].items()}
        else:
            out = run_cell(ctx, control=p["control"] and not train)
            rec["program"] = out.get("numbers") or {
                k: v["value"] for k, v in out["checks"].items()}
            rec["metrics"] = out["metrics"]
            rec["memory_peak_bytes"] = out["device"]["memory_peak_bytes"]
            if p["control"]:
                if train:
                    gc.collect()
                    torch.cuda.empty_cache()
                    ctl = run_cell(_ctx(p, seed, dev, rank, world, host,
                                        "compress"))
                    rec["control"] = {k: v["value"]
                                      for k, v in ctl["checks"].items()}
                else:
                    rec["control"] = out["control"]
        rec["correct"] = out["correct"]
        if rank == 0:
            print(json.dumps(rec), file=sys.stderr, flush=True)
            if p.get("out"):
                with open(p["out"], "a") as f:
                    f.write(json.dumps(rec) + "\n")
        recs.append(rec)
        del ctx, out
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return recs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("half", "rank_partial"),
                    default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    _environment()
    import torch

    from bench.harness import load_cell
    chips = load_cell(args.workload)[1]["chips"]
    p = {"workload": args.workload,
         "seeds": [int(s) for s in args.seeds.split(",")],
         "seconds": args.seconds, "control": args.control,
         "fault": args.fault, "small": False, "out": args.out}
    if chips == 1:
        recs = readings(0, 1, torch.device("cuda", 0), None, p)
    else:
        from bench.ranks import launch
        recs = launch(chips, "cuda", readings, p,
                      deadline=600 + 300 * len(p["seeds"]))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
