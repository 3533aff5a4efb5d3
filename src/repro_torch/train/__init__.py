"""Train and serve step functions, the data- and tensor-parallel steps over a
mesh, and the sharding specs of every (arch x shape) cell."""
from .step import (
    TrainState,
    accumulate_grads,
    build_decode_step,
    build_prefill_step,
    build_train_step,
    cache_logical_axes,
    init_train_state,
    input_specs,
    shard_state,
    sharded_grads,
    state_shardings,
)

__all__ = [
    "TrainState", "accumulate_grads", "build_decode_step",
    "build_prefill_step", "build_train_step", "cache_logical_axes",
    "init_train_state", "input_specs", "shard_state", "sharded_grads",
    "state_shardings",
]
