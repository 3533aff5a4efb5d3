#!/usr/bin/env python3
"""Counts behind the packed match kernel's design (``csrc/tcam_packed.cu``)
on the Give Me Some Credit tree, computed on the host from the layout: no
timing, no card.

    PYTHONPATH=src python tools/packed_walk_stats.py [--tiles 48]

It fits CART at the benchmark parameters, compiles at S=128, and, for
ideal hardware (kmax 0) and for the SA kmax that ``chip_smoke.py`` phase 4
draws (``default_rng(1)``, sigma 0.08), prints:

* which test each (row, division) takes in the kernel: never (kmax < 0),
  always (kmax >= S, or kmax >= 0 on a division without a cared cell),
  the popcount sum (any other kmax > 0) or the OR test (kmax = 0), and the
  share of (warp, division) pairs holding a popcount row;
* divisions evaluated per (word, row) pair;
* over ``--tiles`` random 64-word tiles: the distinct words per (tile,
  division), and the warp steps each walk of the later divisions takes,
  one step per word (``word_steps``) or one per class of equal words
  (``class_steps``, as the kernel walks): the per-thread walk (the
  slowest lane of the warp sets its count), the warp-union walk (the
  union of the testing rows' live words) and the all-words walk (the
  whole tile while a testing row has a live pair).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import compile_tree, encode_inputs, train_tree  # noqa: E402
from repro_torch.dt import DATASETS, load_split  # noqa: E402
from repro_torch.kernels import sa_kmax  # noqa: E402

WORDS, WARP = 64, 32   # the kernel's tile width and a warp's rows


def walk_counts(xp, is0, is1, km, s: int, tiles: int) -> dict:
    r, w = is0.shape
    d = w // s
    cared = (is0 | is1).reshape(r, d, s).any(-1)
    always = (km >= s) | (~cared & (km >= 0))
    testing = torch.from_numpy((km >= 0) & ~always)
    idx = np.random.default_rng(0).choice(xp.shape[0] // WORDS, tiles,
                                          replace=False)
    rows = (idx[:, None] * WORDS + np.arange(WORDS)).ravel()
    # class of each (tile, word, division): words equal in that division
    cls = np.zeros((tiles, WORDS, d), np.int64)
    for t in range(tiles):
        blk = xp[rows[t * WORDS:(t + 1) * WORDS]].reshape(WORDS, d, s)
        for j in range(d):
            cls[t, :, j] = np.unique(blk[:, j], axis=0,
                                     return_inverse=True)[1].ravel()
    cls = torch.from_numpy(cls)
    x = torch.from_numpy(xp[rows].astype(np.float32))
    p0 = torch.from_numpy(is0.astype(np.float32))
    p1 = torch.from_numpy(is1.astype(np.float32))
    kt = torch.from_numpy(km)
    live = torch.ones((x.shape[0], r), dtype=torch.bool)
    evals = torch.zeros((x.shape[0], r), dtype=torch.int64)
    walks = ("per_thread", "warp_union", "all_words")
    word_steps = dict.fromkeys(walks, 0)
    class_steps = dict.fromkeys(walks, 0)
    for j in range(d):
        if j:
            lv = (live & testing[:, j][None]).reshape(tiles, WORDS, r // WARP,
                                                     WARP)
            union = lv.any(-1)                        # (tiles, words, warps)
            walked = union.any(1)                     # (tiles, warps)
            word_steps["per_thread"] += int(lv.sum(1).max(-1).values.sum())
            word_steps["warp_union"] += int(union.sum())
            word_steps["all_words"] += WORDS * int(walked.sum())
            onehot = torch.nn.functional.one_hot(cls[:, :, j], WORDS).bool()
            n_cls = onehot.any(1).sum(-1)             # (tiles,)
            class_steps["all_words"] += int((walked * n_cls[:, None]).sum())
            for t in range(tiles):
                oh = onehot[t].float()                # (words, classes)
                lane = torch.einsum("wgl,wc->glc", lv[t].float(), oh) > 0
                class_steps["per_thread"] += int(lane.sum(-1).max(-1)
                                                 .values.sum())
                class_steps["warp_union"] += int(lane.any(1).sum())
        evals += live
        cols = slice(j * s, (j + 1) * s)
        m = x[:, cols] @ p0[:, cols].T + (1 - x[:, cols]) @ p1[:, cols].T
        live &= m.to(torch.int32) <= kt[:, j][None]
    distinct = (torch.nn.functional.one_hot(cls, WORDS).any(1)
                .sum(-1).double().mean())
    return {"evals_per_pair": float(evals.double().mean()),
            "distinct_words_per_tile_division": float(distinct),
            "later_division_word_steps": word_steps,
            "later_division_class_steps": class_steps}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, default=48)
    args = ap.parse_args()
    spec = DATASETS["credit"]
    xtr, ytr, xte, _ = load_split("credit")
    tree = train_tree(xtr, ytr, max_depth=spec.max_depth,
                      max_leaves=spec.max_leaves,
                      min_samples_leaf=spec.min_samples_leaf)
    compiled = compile_tree(tree, s=128)
    lay = compiled.layout
    s, (r, w) = lay.s, lay.cells.shape
    d = w // s
    xp = lay.pad_inputs(encode_inputs(compiled.lut, xte))
    is0, is1 = lay.cells == 0, lay.cells == 1
    cared = (is0 | is1).reshape(r, d, s).any(-1)
    offsets = np.random.default_rng(1).normal(0.0, 0.08, (r, d))
    out = {"layout": [r, w], "s": s,
           "all_dont_care_share": float(1 - cared.mean())}
    for name, km in (("ideal", np.zeros((r, d), np.int32)),
                     ("sa", sa_kmax(lay, offsets))):
        always = (km >= s) | (~cared & (km >= 0))
        popc = (km > 0) & ~always
        out[name] = {
            "kmax_share": {"-1": float((km < 0).mean()),
                           "0": float((km == 0).mean()),
                           ">0": float((km > 0).mean())},
            "test_share": {"never": float((km < 0).mean()),
                           "always": float(always.mean()),
                           "popcount": float(popc.mean()),
                           "or": float(((km == 0) & ~always).mean())},
            "warp_division_popcount_share": float(
                popc.reshape(r // WARP, WARP, d).any(1).mean()),
            "tiles": args.tiles,
            **walk_counts(xp, is0, is1, km, s, args.tiles)}
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
