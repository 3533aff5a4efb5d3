#!/usr/bin/env python3
"""The readings the limits of ``bench/limits/<workload>.json`` are set
from, on the card at the cell's own size: for each seed, one run of the
cell with a short window and the numbers its check compares, for the
program and, with ``--control``, for the control (serving: the reference
with float8 operands put in the program's place; training: the program's
own int8 path, ``compress``).  ``--fault half`` plants the fault of half
the batch left out (the step's gradient is the mean over the first half
of the rows) in the program instead.  One JSON line a seed:

    python3 bench/calibrate.py --workload qwen3moe-l4.prefill-mix \\
        --seeds 11,12,13 --seconds 3 --control

The benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _environment  # noqa: E402


@contextlib.contextmanager
def _half_batch():
    """The train step's gradient over the first half of each batch's
    rows only (the mean over those)."""
    from unittest import mock

    from repro_torch.train import step as step_mod
    whole = step_mod.accumulate_grads

    def half(cfg, params, batch, **kw):
        n = next(iter(batch.values())).shape[0] // 2
        return whole(cfg, params, {k: v[:n] for k, v in batch.items()}, **kw)
    with mock.patch.object(step_mod, "accumulate_grads", half):
        yield


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("half",), default=None)
    args = ap.parse_args()
    _environment()
    import gc

    import torch

    from bench.harness import Ctx, load_cell, run_cell
    manifest, cell, conf, traffic, limits = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        def ctx(variant=None):
            return Ctx(workload=args.workload, seed=seed,
                       seconds=args.seconds, trace=False,
                       t0=time.perf_counter(), manifest=manifest, cell=cell,
                       conf=conf, traffic=traffic, limits=limits, device=dev,
                       variant=variant, card=torch.cuda.get_device_name(0))
        train = traffic["kind"] == "train"
        rec = {"workload": args.workload, "seed": seed}
        if args.fault:
            with _half_batch():
                out = run_cell(ctx())
            rec["fault_" + args.fault] = {k: v["value"] for k, v in
                                          out["checks"].items()}
        else:
            out = run_cell(ctx(), control=args.control and not train)
            rec["program"] = out.get("numbers") or {
                k: v["value"] for k, v in out["checks"].items()}
            rec["metrics"] = out["metrics"]
            rec["memory_peak_bytes"] = out["device"]["memory_peak_bytes"]
            if args.control:
                if train:
                    gc.collect()
                    torch.cuda.empty_cache()
                    ctl = run_cell(ctx("compress"))
                    rec["control"] = {k: v["value"]
                                      for k, v in ctl["checks"].items()}
                else:
                    rec["control"] = out["control"]
        print(json.dumps(rec), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
