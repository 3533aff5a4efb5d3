"""paligemma-3b [vlm]: SigLIP stub frontend + gemma backbone.

18L d_model=2048 8H (GQA kv=1 => MQA) d_ff=16384 vocab=257216, head_dim=256,
GeGLU, embedding scaling [arXiv:2407.07726].  The vision frontend is a STUB
per assignment: ``input_specs`` provides 256 precomputed patch embeddings
that the backbone attends to bidirectionally (prefix-LM masking).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma_3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    pattern=("attn+mlp",),
    mlp_act="gelu",
    rope_theta=10_000.0,
    frontend_tokens=256,
    tie_embeddings=True,
    emb_scale=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, frontend_tokens=8,
    )
