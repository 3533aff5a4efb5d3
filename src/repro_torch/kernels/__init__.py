"""The TCAM search on the GPU: two hand-written CUDA kernels for sm_90a and
their plain PyTorch versions.

  tcam_match.py  — bitplane kernel wrapper (engine 'mxu'; every cell state
                   incl. SAF CELL_MM), csrc/tcam_match.cu
  tcam_packed.py — bit-packed popcount kernel wrapper (engine 'packed'),
                   csrc/tcam_packed.cu
  ops.py         — engine selection, device operands, SA-variability
                   lowering, the serving path ``tcam_infer``
  ref.py         — plain PyTorch oracles both kernels are held against
  _cuda.py       — nvcc build at first use, ctypes loading and launching
"""
from ._cuda import build_all
from .ops import (ENGINES, MatchOperands, finalize_result, prepare_match,
                  run_match, sa_kmax, select_engine, tcam_infer, tcam_match)
from .ref import pack_bits, popcount32, tcam_match_packed_ref, tcam_match_ref
from .tcam_match import tcam_match_cuda, tcam_match_plain
from .tcam_packed import tcam_match_packed_cuda, tcam_match_packed_plain

__all__ = [
    "ENGINES", "MatchOperands", "build_all", "finalize_result",
    "prepare_match", "run_match", "sa_kmax", "select_engine", "tcam_infer",
    "tcam_match", "pack_bits", "popcount32", "tcam_match_packed_ref",
    "tcam_match_ref", "tcam_match_cuda", "tcam_match_plain",
    "tcam_match_packed_cuda", "tcam_match_packed_plain",
]
