"""Assigned architecture configs (+ input-shape cells and skip rules).

Every architecture is selectable via ``--arch <id>``; each has:
  * ``CONFIG``        — the exact full-size published config,
  * ``reduced()``     — a tiny same-family config for CPU smoke tests.

Shape cells (per assignment):
  train_4k    seq 4096,   global batch 256  -> train_step
  prefill_32k seq 32768,  global batch 32   -> prefill (inference)
  decode_32k  seq 32768,  global batch 128  -> serve_step (1 token, 32k cache)
  long_500k   seq 524288, global batch 1    -> serve_step; sub-quadratic only

``long_500k`` runs for jamba (hybrid), rwkv6 (O(1) state) and h2o-danube
(SWA window 4096); pure full-attention archs skip it (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

__all__ = ["ARCHS", "SHAPES", "get_config", "get_reduced", "shape_cells",
           "Shape"]

ARCHS = (
    "paligemma_3b",
    "jamba_v01_52b",
    "dbrx_132b",
    "qwen3_moe_235b_a22b",
    "rwkv6_1p6b",
    "olmo_1b",
    "gemma_7b",
    "phi3_medium_14b",
    "h2o_danube_1p8b",
    "whisper_small",
)

# archs with sub-quadratic sequence mixing (run long_500k)
SUBQUADRATIC = {"jamba_v01_52b", "rwkv6_1p6b", "h2o_danube_1p8b"}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    step: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.reduced()


def shape_cells(arch: str) -> list[Shape]:
    """The shape cells this arch runs (applying the long_500k skip rule)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if arch in SUBQUADRATIC:
        out.append(SHAPES["long_500k"])
    return out


# Per-arch training-cell memory policy, sized for 16 GiB/chip HBM (v5e):
# microbatch accumulation bounds the stacked per-layer activation residuals
# (B_local = 256/data_shards/accum), bf16 params+moments halve the static
# state for the 100B+ MoE models (see EXPERIMENTS.md §Dry-run).
TRAIN_SETTINGS: dict = {
    "paligemma_3b": dict(accum=2),
    "jamba_v01_52b": dict(accum=16, mu_dtype="bfloat16", nu_dtype="bfloat16",
                          accum_dtype="bfloat16"),
    "dbrx_132b": dict(accum=16, mu_dtype="bfloat16", nu_dtype="bfloat16",
                      accum_dtype="bfloat16"),
    "qwen3_moe_235b_a22b": dict(accum=16, param_dtype="bfloat16",
                                mu_dtype="bfloat16", nu_dtype="bfloat16",
                                accum_dtype="bfloat16"),
    "rwkv6_1p6b": dict(accum=1, dp_only=True),
    "olmo_1b": dict(accum=1, dp_only=True),
    "gemma_7b": dict(accum=4),
    "phi3_medium_14b": dict(accum=8),
    "h2o_danube_1p8b": dict(accum=1, dp_only=True),
    "whisper_small": dict(accum=1, dp_only=True),
}


def train_settings(arch: str) -> dict:
    return dict(TRAIN_SETTINGS.get(arch, {}))
