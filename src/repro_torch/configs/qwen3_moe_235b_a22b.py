"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, fine-grained experts,
qk-norm [hf:Qwen/Qwen3-30B-A3B scaled per assignment].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b_a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    pattern=("attn+moe",),
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    qk_norm=True,
    mlp_act="silu",
    rope_theta=1_000_000.0,
    moe_groups=8,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, moe_d_ff=64, vocab_size=512, n_experts=8,
        experts_per_token=2,
    )
