#!/usr/bin/env python3
"""Time the packed match kernel alone at ``chip_smoke.py`` phase 4's shape,
on one GPU: the Give Me Some Credit tree (CART at the benchmark parameters,
``compile_tree(s=128)``), all 12,027 test queries, the SA kmax of phase 4.

    python3 tools/packed_bench.py [--reps 2]

Each rep prints the record of ``chip_smoke.packed_row``: the main-path
call (word pack + match) against its plain version, its bound, the match
alone, division 0 alone, the store floor, the same call at kmax = 0, and
``ptxas``'s report when this run built the library.  It is
the packed row of ``chip_smoke.py`` without the rest of the script, for
timing the kernel while it changes.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("packed_bench: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import compile_tree, encode_inputs, train_tree
    from repro_torch.dt import DATASETS, load_split
    from repro_torch.kernels import build_all, sa_kmax

    cs.record_ptxas(build_all())
    spec = DATASETS["credit"]
    xtr, ytr, xte, _ = load_split("credit")
    tree = train_tree(xtr, ytr, max_depth=spec.max_depth,
                      max_leaves=spec.max_leaves,
                      min_samples_leaf=spec.min_samples_leaf)
    compiled = compile_tree(tree, s=128)
    lay = compiled.layout
    x = torch.from_numpy(lay.pad_inputs(encode_inputs(compiled.lut, xte)))
    x = x.cuda()
    offsets = np.random.default_rng(1).normal(0.0, 0.08, (lay.cells.shape[0],
                                                          lay.n_cwd))
    km_np = sa_kmax(lay, offsets)
    km = torch.from_numpy(km_np).cuda()
    shape = {"B": x.shape[0], "R": km.shape[0], "W": x.shape[1], "S": lay.s,
             "D": km.shape[1]}
    cs.log(cs.card_line())
    rates = cs.pipe_rates()
    for _ in range(args.reps):
        cs.packed_row(lay, x, km_np, km, shape, 0,
                      cs.peak_bw(torch.cuda.get_device_name(0)), rates)
    return 0


if __name__ == "__main__":
    sys.exit(main())
