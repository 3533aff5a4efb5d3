"""Train / serve step builders on one card."""
from .step import (
    TrainState,
    accumulate_grads,
    build_decode_step,
    build_prefill_step,
    build_train_step,
    init_train_state,
)

__all__ = [
    "TrainState", "accumulate_grads", "build_decode_step",
    "build_prefill_step", "build_train_step", "init_train_state",
]
