"""DT2CAM core: the paper's contribution as a composable library.

Layers (bottom-up): cart (DT training) -> reduce (tree parsing + column
reduction) -> encode (ternary adaptive encoding) -> lut (bitplane LUT) ->
synth (S×S tiling, decoder column) -> simulate (functional sim + selective
precharge) -> energy (analog ReCAM model) -> nonideal (SAF / SA-var / noise).
``compiler.DT2CAM`` is the one-call front door.  Everything here is numpy
except ``DT2CAM.infer(backend="torch")``, which runs ``repro_torch.kernels``,
and the drift model and sensing margins (``nonideal.DriftModel``,
``energy.sensing_margins``), which are float64 tensor ops on the device.
"""
from .cart import DecisionTree, predict, train_tree, tree_leaf_ids, tree_paths
from .compiler import (
    DT2CAM,
    CompiledDT,
    FeatureMismatch,
    check_feature_count,
    compile_tree,
)
from .encode import encode_inputs, encode_table, span_code, unary_code
from .energy import (
    DEFAULT_HW,
    HardwareParams,
    bank_figures,
    choose_tile_size,
    dynamic_range,
    f_max,
    SenseMargins,
    forest_figures,
    max_cells_per_row,
    mismatch_probability,
    reprogram_figures,
    sensing_margins,
    t_cwd,
    t_opt,
    write_energy,
)
from .lut import CELL_0, CELL_1, CELL_MM, CELL_X, TernaryLUT, bitplanes
from .nonideal import (
    IDEAL,
    DriftModel,
    DriftSpec,
    NonIdealSpec,
    SAFMask,
    apply_saf,
    apply_saf_mask,
    noisy_inputs,
    pin_stuck,
    sample_drift,
    sample_saf,
)
from .reduce import CMP_BETWEEN, CMP_GT, CMP_LE, CMP_NONE, RuleTable, reduce_tree
from .simulate import SimResult, mismatch_counts, simulate
from .synth import TCAMLayout, synthesize

__all__ = [
    "DecisionTree", "predict", "train_tree", "tree_paths", "tree_leaf_ids",
    "DT2CAM", "CompiledDT", "compile_tree",
    "FeatureMismatch", "check_feature_count",
    "encode_inputs", "encode_table", "span_code", "unary_code",
    "DEFAULT_HW", "HardwareParams", "choose_tile_size", "dynamic_range",
    "f_max", "max_cells_per_row", "t_cwd", "t_opt", "bank_figures",
    "forest_figures", "reprogram_figures", "write_energy",
    "SenseMargins", "sensing_margins", "mismatch_probability",
    "CELL_0", "CELL_1", "CELL_MM", "CELL_X", "TernaryLUT", "bitplanes",
    "IDEAL", "NonIdealSpec", "SAFMask", "apply_saf", "apply_saf_mask",
    "noisy_inputs", "sample_saf", "pin_stuck",
    "DriftSpec", "DriftModel", "sample_drift",
    "CMP_BETWEEN", "CMP_GT", "CMP_LE", "CMP_NONE", "RuleTable", "reduce_tree",
    "SimResult", "mismatch_counts", "simulate",
    "TCAMLayout", "synthesize",
]
