"""DT2CAM on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout and names mirror the JAX package, so each module has a
counterpart there; the port imports neither JAX nor the JAX package.  Its
two TCAM match kernels are hand-written CUDA for sm_90a (``csrc/``), built
by ``nvcc`` at first use.

Device rule: every entry point takes ``device=None``, which means
``"cuda"``; without CUDA it raises unless the caller asks for
``device="cpu"``, where the kernels' plain PyTorch versions run.

    >>> import repro_torch
    >>> model = repro_torch.DT2CAM(s=128).fit(X, y)
    >>> res = model.infer(Xq, backend="torch")          # CUDA kernels
    >>> with repro_torch.TCAMServer(model.compiled) as srv:
    ...     preds = [r.prediction for r in srv.serve(Xq)]
"""
from .convert import compiled_from_arrays
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
    compile_tree,
    predict,
    simulate,
    train_tree,
)
from .device import resolve_device
from .kernels import ENGINES, sa_kmax, select_engine, tcam_infer, tcam_match
from .serve import ServeConfig, TCAMServer

__all__ = [
    "DEFAULT_HW", "DT2CAM", "IDEAL", "CompiledDT", "FeatureMismatch",
    "HardwareParams", "NonIdealSpec", "SimResult", "TCAMLayout",
    "compile_tree", "predict", "simulate", "train_tree",
    "compiled_from_arrays", "resolve_device",
    "ENGINES", "sa_kmax", "select_engine", "tcam_infer", "tcam_match",
    "ServeConfig", "TCAMServer",
]
