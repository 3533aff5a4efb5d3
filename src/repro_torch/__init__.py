"""DT2CAM on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout and names mirror the JAX package, so each module has a
counterpart there; the port imports neither JAX nor the JAX package.  Its
two TCAM match kernels are hand-written CUDA for sm_90a (``csrc/``), built
by ``nvcc`` at first use.

Forests (one TCAM bank per tree) run through ``ForestExecutor`` and a
forest-mode ``TCAMServer``; engine 'mxu' there is the bitplane kernel with a
bank grid axis.

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
"""
from .convert import compiled_from_arrays, forest_from_arrays
from .core import (
    DEFAULT_HW,
    DT2CAM,
    IDEAL,
    CompiledDT,
    FeatureMismatch,
    HardwareParams,
    NonIdealSpec,
    SimResult,
    TCAMLayout,
    bank_figures,
    compile_tree,
    forest_figures,
    predict,
    simulate,
    train_tree,
)
from .device import resolve_device
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
from .kernels import (BANKED_ENGINES, ENGINES, sa_kmax, select_engine,
                      tcam_infer, tcam_match, tcam_match_banked)
from .serve import ServeConfig, TCAMServer

__all__ = [
    "DEFAULT_HW", "DT2CAM", "IDEAL", "CompiledDT", "FeatureMismatch",
    "HardwareParams", "NonIdealSpec", "SimResult", "TCAMLayout",
    "compile_tree", "predict", "simulate", "train_tree",
    "compiled_from_arrays", "forest_from_arrays", "resolve_device",
    "ENGINES", "sa_kmax", "select_engine", "tcam_infer", "tcam_match",
    "ServeConfig", "TCAMServer",
    # forests
    "bank_figures", "forest_figures", "CompiledForest", "ForestBank",
    "ForestResult", "compile_forest", "train_forest", "forest_infer_ref",
    "aggregate_votes", "ForestPlan", "plan_forest", "ForestExecutor",
    "FOREST_ENGINES", "tcam_match_banked", "BANKED_ENGINES",
]
