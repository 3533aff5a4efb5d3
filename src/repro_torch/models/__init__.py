"""LM substrate on PyTorch: the serving path (forward, prefill, decode) and
the training loss (``loss_fn``, with its backward through autograd) of every
configuration the repo has (the attention families, the mamba and rwkv
mixers, the encoder-decoder), with the TCAM decision-tree MoE router.

Plain functions on tensors: params are nested dicts of tensors (the JAX
package's pytree, leaf for leaf) with a parallel tree of logical-axis names.
"""
from .config import ARCH_FAMILIES, ModelConfig
from .lm import (decode_step, encode_audio, forward, init_cache, loss_fn,
                 prefill)
from .params import init_params, param_count, param_logical_axes

__all__ = [
    "ARCH_FAMILIES", "ModelConfig",
    "decode_step", "encode_audio", "forward", "init_cache", "loss_fn",
    "prefill",
    "init_params", "param_count", "param_logical_axes",
]
