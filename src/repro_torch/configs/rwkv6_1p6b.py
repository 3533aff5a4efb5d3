"""rwkv6-1.6b "Finch" [ssm]: attention-free, data-dependent decay
[arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536; 32 wkv heads of dim 64; RWKV
channel-mix as the FFN.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_1p6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # wkv heads (d_model / rwkv_head_dim)
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    pattern=("rwkv+cmix",),
    rwkv_head_dim=64,
    rope_theta=0.0,      # attention-free
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, rwkv_head_dim=16,
    )
