"""olmo-1b [dense]: non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo_1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    pattern=("attn+mlp",),
    norm_type="nonparam",
    mlp_act="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
    )
