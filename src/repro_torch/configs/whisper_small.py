"""whisper-small [audio]: encoder-decoder backbone; conv frontend is a STUB
per assignment (``input_specs`` provides 1500 precomputed frame embeddings)
[arXiv:2212.04356].

12L encoder + 12L decoder, d_model=768 12H (MHA) d_ff=3072 vocab=51865.
Learned positional embeddings (no RoPE); decode shapes mechanically extend
the decoder position table to 32k (backbone-only per assignment).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper_small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    pattern=("attn+mlp",),
    mlp_act="gelu",
    rope_theta=0.0,       # learned positional embeddings
    encoder_layers=12,
    encoder_seq=1500,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, encoder_layers=2, encoder_seq=24,
    )
