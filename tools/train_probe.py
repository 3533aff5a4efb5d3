#!/usr/bin/env python3
"""The trainer of ``chip_smoke.py`` phase 11 on the card, two ways.

``--lrs``: the loss over ``TRAIN_DECREASE_STEPS`` steps of
``chip_smoke.TRAIN_ARCH`` whole at ``TRAIN_BATCH`` x ``TRAIN_DECREASE_SEQ``
tokens, from a fresh state for each learning rate (``TRAIN_OPT``
otherwise), on the planted-structure stream of ``CALIBRATION_SEED``: how
far the loss falls in phase 11's short run.  ``--profile``: one train step at phase 11's main shape traced by
``torch.profiler`` after two untimed steps, with its wall time, the
device's busy time and idle share, and the operators by device time, most
first (``tools/lm_profile.py``'s tracer).  GPU only.

    python3 tools/train_probe.py --lrs 3e-4 1e-3 3e-3
    python3 tools/train_probe.py --profile
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

# Not chip_smoke.LM_SEED: phase 11's decrease margin is set from how far
# the loss falls on this stream, and checked on LM_SEED's.
CALIBRATION_SEED = 1


def loss_run(lr: float) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, init_train_state

    cfg = get_config(cs.TRAIN_ARCH)
    opt = AdamWConfig(**{**cs.TRAIN_OPT, "lr": lr})
    dev = torch.device("cuda")
    state = init_train_state(cfg, CALIBRATION_SEED, opt_cfg=opt, device=dev)
    step = build_train_step(cfg, opt, remat=cs.TRAIN_REMAT)
    pipe = TokenPipeline(cfg, cs.TRAIN_BATCH, cs.TRAIN_DECREASE_SEQ,
                         seed=CALIBRATION_SEED)
    losses = []
    for i in range(cs.TRAIN_DECREASE_STEPS):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    return {"lr": lr, "seed": CALIBRATION_SEED, "batch": cs.TRAIN_BATCH,
            "seq": cs.TRAIN_DECREASE_SEQ, "losses": losses,
            "first5": statistics.mean(losses[:5]),
            "last5": statistics.mean(losses[-5:])}


def profile_step() -> dict:
    import torch

    import chip_smoke as cs
    from lm_profile import traced
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, init_train_state

    cfg = get_config(cs.TRAIN_ARCH)
    opt = AdamWConfig(**cs.TRAIN_OPT)
    dev = torch.device("cuda")
    state = init_train_state(cfg, cs.LM_SEED, opt_cfg=opt, device=dev)
    step = build_train_step(cfg, opt, remat=cs.TRAIN_REMAT)
    pipe = TokenPipeline(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=cs.LM_SEED)
    for i in range(2):
        state, _ = step(state, pipe.batch_at(i))
    batch = pipe.batch_at(2)
    rec = traced(lambda: step(state, batch))
    rec.update(arch=cfg.name, batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ,
               remat=cs.TRAIN_REMAT)
    return rec


def main() -> int:
    import gc

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lrs", type=float, nargs="*", default=[])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_probe: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    for lr in args.lrs:
        print(json.dumps({"loss_run": loss_run(lr)}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if args.profile:
        print(json.dumps({"train_step_profile": profile_step()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
