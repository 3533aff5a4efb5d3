"""Tree-ensemble -> multi-bank TCAM on the GPU: compiler, sharding plan,
executor.

The paper's pipelined multi-array throughput story generalizes from one tree
on one chip to a forest sharded across TCAM banks:

  sklearn_io.py — lossless import of fitted sklearn trees/forests (duck-typed;
                  sklearn itself is never imported)
  compiler.py   — compile_forest / ForestBank / CompiledForest + the
                  pure-numpy reference executor and vote aggregation
  plan.py       — ForestPlan: power-of-two shape bucketing, bank stacking
  executor.py   — ForestExecutor: banked execution on the card (the bitplane
                  CUDA kernel with a bank grid axis, or PyTorch ops),
                  pipelined across groups
"""
from .compiler import (
    VOTES,
    CompiledForest,
    ForestBank,
    ForestResult,
    aggregate_votes,
    compile_forest,
    forest_infer_ref,
    train_forest,
)
from .executor import FOREST_ENGINES, ForestExecutor, encode_group
from .plan import ForestPlan, PlanGroup, plan_forest
from .sklearn_io import from_sklearn_tree, is_sklearn_forest, leaf_proba_rows

__all__ = [
    "VOTES", "CompiledForest", "ForestBank", "ForestResult",
    "aggregate_votes", "compile_forest", "forest_infer_ref", "train_forest",
    "ForestPlan", "PlanGroup", "plan_forest",
    "from_sklearn_tree", "is_sklearn_forest", "leaf_proba_rows",
    "ForestExecutor", "FOREST_ENGINES", "encode_group",
]
