"""LM substrate on PyTorch: the serving path (forward, prefill, decode) of
every configuration the repo has (the attention families, the mamba and
rwkv mixers, the encoder-decoder), with the TCAM decision-tree MoE router.

Plain functions on tensors: params are nested dicts of tensors (the JAX
package's pytree, leaf for leaf) with a parallel tree of logical-axis names.
The training loss comes in a later slice of the port (ROADMAP Queue A).
"""
from .config import ARCH_FAMILIES, ModelConfig
from .lm import decode_step, encode_audio, forward, init_cache, prefill
from .params import init_params, param_count, param_logical_axes

__all__ = [
    "ARCH_FAMILIES", "ModelConfig",
    "decode_step", "encode_audio", "forward", "init_cache", "prefill",
    "init_params", "param_count", "param_logical_axes",
]
