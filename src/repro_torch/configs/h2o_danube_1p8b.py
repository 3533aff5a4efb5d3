"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096 —
sub-quadratic, so it runs the long_500k cell with a 4096-slot ring cache.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o_danube_1p8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    pattern=("swa+mlp",),
    sliding_window=4096,
    mlp_act="silu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=16,
    )
