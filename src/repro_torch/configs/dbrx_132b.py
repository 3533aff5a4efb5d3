"""dbrx-132b [moe]: 16 experts top-4, fine-grained MoE
[hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352; every layer is MoE.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx_132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    pattern=("attn+moe",),
    n_experts=16,
    experts_per_token=4,
    moe_d_ff=10752,
    mlp_act="silu",
    rope_theta=500_000.0,
    moe_groups=4,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, moe_d_ff=128, vocab_size=512, n_experts=4,
        experts_per_token=2,
    )
