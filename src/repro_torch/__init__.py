"""DT2CAM on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout and names mirror the JAX package, so each module has a
counterpart there; the port imports neither JAX nor the JAX package.  Its
two TCAM match kernels are hand-written CUDA for sm_90a (``csrc/``), built
by ``nvcc`` at first use.

Forests (one TCAM bank per tree) run through ``ForestExecutor`` and a
forest-mode ``TCAMServer``; engine 'mxu' there is the bitplane kernel with a
bank grid axis.

Temporal degradation (drift, retention, read disturb) runs on the single-tree
``TCAMServer`` with ``NonIdealSpec(drift=DriftSpec(...))``: the drift readout
and the sensing margins are float64 tensor ops on the card, scrubs go
through ``degradation.ScrubScheduler``.

The LM serving path of every configuration (``forward``, ``prefill``,
``decode_step`` over ``init_params`` / ``init_cache``; configs in
``repro_torch.configs``) runs on plain tensor ops, with the MoE layer's
TCAM decision-tree router in ``repro_torch.models.tcam_router``.  Training
(``loss_fn`` with its backward through autograd, AdamW, int8 error-feedback
compression, ``build_train_step`` with accumulation and remat, checkpoints
in the JAX package's layout, ``FaultTolerantLoop``) runs on the same ops.

Device rule: every entry point takes ``device=None``, which means
``"cuda"``; without CUDA it raises unless the caller asks for
``device="cpu"``, where the kernels' plain PyTorch versions run.

    >>> import repro_torch
    >>> model = repro_torch.DT2CAM(s=128).fit(X, y)
    >>> res = model.infer(Xq, backend="torch")          # CUDA kernels
    >>> with repro_torch.TCAMServer(model.compiled) as srv:
    ...     preds = [r.prediction for r in srv.serve(Xq)]
    >>> forest = repro_torch.compile_forest(repro_torch.train_forest(X, y))
    >>> res = repro_torch.ForestExecutor(forest, engine="mxu").infer(Xq)
    >>> state = repro_torch.init_train_state(cfg, 0)
    >>> state, metrics = repro_torch.build_train_step(cfg)(state, batch)
"""
from .checkpoint import CheckpointManager, restore_resharded
from .convert import (compiled_from_arrays, forest_from_arrays,
                      lm_params_from_arrays, train_state_from_arrays,
                      train_state_to_arrays)
from .core import (
    CELL_0,
    CELL_1,
    CELL_MM,
    CELL_X,
    DEFAULT_HW,
    DT2CAM,
    IDEAL,
    CompiledDT,
    DecisionTree,
    DriftModel,
    DriftSpec,
    FeatureMismatch,
    HardwareParams,
    NonIdealSpec,
    RuleTable,
    SAFMask,
    SenseMargins,
    SimResult,
    TCAMLayout,
    TernaryLUT,
    bank_figures,
    check_feature_count,
    compile_tree,
    encode_inputs,
    encode_table,
    forest_figures,
    mismatch_probability,
    predict,
    reduce_tree,
    sample_drift,
    sensing_margins,
    simulate,
    synthesize,
    train_tree,
)
from .degradation import (ScrubPolicy, ScrubReport, ScrubScheduler,
                          layout_margins, plan_refresh)
from .device import resolve_device
from .dt import DATASETS, load, load_split, normalize
from .forest import (
    FOREST_ENGINES,
    CompiledForest,
    ForestBank,
    ForestExecutor,
    ForestPlan,
    ForestResult,
    aggregate_votes,
    compile_forest,
    forest_infer_ref,
    plan_forest,
    train_forest,
)
from .kernels import (BANKED_ENGINES, ENGINES, finalize_result, sa_kmax,
                      select_engine, tcam_infer, tcam_match,
                      tcam_match_banked)
from .lifecycle import (
    LifecycleManager,
    ModelRegistry,
    ModelVersion,
    RemapResult,
    WearTracker,
    WritePlan,
    content_hash,
    plan_delta,
    plan_forest_delta,
    plan_full,
    wear_level_rows,
)
from .models import (ARCH_FAMILIES, ModelConfig, decode_step, forward,
                     init_cache, init_params, loss_fn, param_count,
                     param_logical_axes, prefill)
from .optim import (AdamWConfig, OptState, adamw_init, adamw_update,
                    cosine_schedule, dequantize_int8, ef_compress, ef_init,
                    global_norm, quantize_int8)
from .runtime import FaultTolerantLoop, StragglerMonitor
from .serve import (ComputeFailed, DeadlineExceeded, PromotionReport,
                    Rejected, RequestResult, ServeConfig, ServingError,
                    TCAMServer)
from .train import (TrainState, build_decode_step, build_prefill_step,
                    build_train_step, init_train_state)

__all__ = [
    # core: compile + simulate
    "DT2CAM", "CompiledDT", "compile_tree", "DecisionTree", "train_tree",
    "predict", "RuleTable", "reduce_tree", "encode_table", "encode_inputs",
    "TernaryLUT", "TCAMLayout", "synthesize", "simulate", "SimResult",
    "CELL_0", "CELL_1", "CELL_X", "CELL_MM",
    # validation + non-idealities
    "FeatureMismatch", "check_feature_count",
    "NonIdealSpec", "IDEAL", "SAFMask",
    "DriftSpec", "DriftModel", "sample_drift",
    # hardware model
    "HardwareParams", "DEFAULT_HW", "bank_figures", "forest_figures",
    "SenseMargins", "sensing_margins", "mismatch_probability",
    # degradation: scrub-and-refresh scheduling
    "ScrubPolicy", "ScrubReport", "ScrubScheduler",
    "plan_refresh", "layout_margins",
    # forests
    "CompiledForest", "ForestBank", "ForestResult", "compile_forest",
    "train_forest", "forest_infer_ref", "aggregate_votes",
    "ForestPlan", "plan_forest",
    # datasets
    "DATASETS", "load", "load_split", "normalize",
    # lifecycle: registry + delta reprogramming + wear
    "ModelRegistry", "ModelVersion", "content_hash",
    "WritePlan", "plan_delta", "plan_full", "plan_forest_delta",
    "WearTracker", "RemapResult", "wear_level_rows", "LifecycleManager",
    # kernels
    "tcam_infer", "tcam_match", "tcam_match_banked", "ENGINES",
    "BANKED_ENGINES", "select_engine", "finalize_result", "sa_kmax",
    # executors + serving
    "ForestExecutor", "FOREST_ENGINES",
    "TCAMServer", "ServeConfig", "RequestResult", "PromotionReport",
    "ServingError", "Rejected", "DeadlineExceeded", "ComputeFailed",
    # device and conversion from the JAX package
    "resolve_device", "compiled_from_arrays", "forest_from_arrays",
    "lm_params_from_arrays", "train_state_from_arrays",
    "train_state_to_arrays",
    # the LM: serving path and training loss
    "ARCH_FAMILIES", "ModelConfig", "decode_step", "forward", "init_cache",
    "prefill", "loss_fn", "init_params", "param_count", "param_logical_axes",
    # training: optimizer, steps, checkpoints, fault-tolerant loop
    "AdamWConfig", "OptState", "adamw_init", "adamw_update",
    "cosine_schedule", "global_norm", "quantize_int8", "dequantize_int8",
    "ef_init", "ef_compress",
    "TrainState", "init_train_state", "build_train_step",
    "build_prefill_step", "build_decode_step",
    "CheckpointManager", "restore_resharded",
    "FaultTolerantLoop", "StragglerMonitor",
]
