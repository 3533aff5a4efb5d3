"""jamba-v0.1-52b [hybrid]: Mamba + attention 1:7 interleave, MoE every
other layer (16 experts top-2) [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  The repeating
8-layer Jamba block places the attention layer at offset 4 and MoE on odd
offsets — exactly the published 1:7 attn:mamba ratio with e=16/k=2.
"""
import dataclasses

from ..models.config import ModelConfig

_PATTERN = (
    "mamba+mlp", "mamba+moe", "mamba+mlp", "mamba+moe",
    "attn+mlp", "mamba+moe", "mamba+mlp", "mamba+moe",
)

CONFIG = ModelConfig(
    name="jamba_v01_52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    pattern=_PATTERN,
    n_experts=16,
    experts_per_token=2,
    mlp_act="silu",
    rope_theta=10_000.0,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    moe_groups=2,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, n_experts=4, experts_per_token=2,
    )
