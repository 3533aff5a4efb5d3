"""gemma-7b [dense]: GeGLU, head_dim=256, embedding scaling
[arXiv:2403.08295].

28L d_model=3072 16H (MHA kv=16) d_ff=24576 vocab=256000.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma_7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    pattern=("attn+mlp",),
    mlp_act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    emb_scale=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
    )
