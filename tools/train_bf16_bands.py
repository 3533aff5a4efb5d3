#!/usr/bin/env python3
"""The bf16 gradient bands of ``tests/test_torch_train.py``, arch by arch:
for every gradient leaf, the reference's bf16 distance from its f32
gradient (the band) and the port's, each as a fraction of the leaf's
largest |g|, with the port's bf16 routing replaying the reference's as the
test does.  A distance is read two ways, as the test reads it: the
largest difference over the largest |g| (``max``), and the norm of the
difference over the gradient's norm (``norm``).  Prints one JSON line per
arch: for each way, the smallest, median and largest band, the port's
largest distance and the largest ratio of the port's distance to its
leaf's band.  CPU, reduced configs.

    PYTHONPATH=src:tests python3 tools/train_bf16_bands.py [arch ...]
"""
from __future__ import annotations

import json
import sys

import numpy as np

from test_torch_train import _rel, _rel_norm, make_case

ARCHS = ("olmo_1b", "gemma_7b", "phi3_medium_14b", "h2o_danube_1p8b",
         "paligemma_3b", "qwen3_moe_235b_a22b", "dbrx_132b",
         "jamba_v01_52b", "rwkv6_1p6b", "whisper_small")


def bands(arch: str) -> dict:
    case = make_case(arch)
    port, ref, ref_bf16 = (case["bfloat16"][0][2], case["float32"][1][2],
                           case["bfloat16"][1][2])
    used = [(a, b, r) for a, b, r in zip(port, ref_bf16, ref)
            if np.abs(r).max()]
    out = {"arch": arch, "leaves": len(used)}
    for name, dist in (("max", _rel), ("norm", _rel_norm)):
        band = np.array([dist(b, r, r) for _, b, r in used])
        err = np.array([dist(a, r, r) for a, _, r in used])
        out[name] = {"band_min": band.min(),
                     "band_median": float(np.median(band)),
                     "band_max": band.max(), "port_max": err.max(),
                     "ratio_max": (err / band).max()}
    return out


if __name__ == "__main__":
    for arch in sys.argv[1:] or ARCHS:
        print(json.dumps(bands(arch)), flush=True)
