"""phi3-medium-14b [dense]: RoPE + SwiGLU + GQA [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
40 heads / 10 kv-heads do not divide the 16-way tensor axis: attention
activations fall back to replicated (rules drop the axis) while the merged
QKV projections stay sharded — see EXPERIMENTS.md §Perf for the padded-head
hillclimb.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3_medium_14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    pattern=("attn+mlp",),
    mlp_act="silu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
    )
