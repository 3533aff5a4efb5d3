"""The TCAM search on the GPU: two hand-written CUDA kernels for sm_90a (the
bitplane one with a single-bank and a banked entry) and their plain PyTorch
versions.

  tcam_match.py  — bitplane kernel wrappers (engine 'mxu'; every cell state
                   incl. SAF CELL_MM) and its pack kernel,
                   csrc/tcam_match.cu
  tcam_packed.py — bit-packed popcount kernel wrappers (engine 'packed'),
                   csrc/tcam_packed.cu (shares csrc/tcam_tile.cuh and the
                   pack kernel with the bitplane kernel)
  banked.py      — a forest group's banks at once: the bitplane kernel with
                   a bank grid axis (engine 'mxu'), or PyTorch ops
  ops.py         — engine selection, device operands, SA-variability
                   lowering, the serving path ``tcam_infer``
  ref.py         — plain PyTorch oracles both kernels are held against
  _cuda.py       — nvcc build at first use, ctypes loading and launching
"""
from ._cuda import MATCH_PATH_LAUNCHES, PACKED_PATH_LAUNCHES, build_all
from .banked import (BANKED_ENGINES, BankedOperands, prepare_banked,
                     run_banked, tcam_match_banked,
                     tcam_match_banked_bits_cuda, tcam_match_banked_cuda,
                     tcam_match_banked_plain)
from .ops import (ENGINES, MatchOperands, finalize_result, prepare_match,
                  run_match, sa_kmax, select_engine, tcam_infer, tcam_match)
from .ref import (pack_bits, pack_divisions, pack_planes, pack_words,
                  packed_division_major, popcount32, tcam_match_banked_ref,
                  tcam_match_bits_ref, tcam_match_packed_bits_ref,
                  tcam_match_packed_ref, tcam_match_ref, words_per_division)
from .tcam_match import (pack_planes_cuda, pack_words_cuda,
                         tcam_match_bits_cuda, tcam_match_cuda,
                         tcam_match_plain)
from .tcam_packed import (tcam_match_packed_bits_cuda, tcam_match_packed_cuda,
                          tcam_match_packed_plain)

__all__ = [
    "ENGINES", "MATCH_PATH_LAUNCHES", "PACKED_PATH_LAUNCHES", "MatchOperands",
    "build_all",
    "finalize_result",
    "prepare_match", "run_match", "sa_kmax", "select_engine", "tcam_infer",
    "tcam_match", "pack_bits", "popcount32", "tcam_match_packed_ref",
    "tcam_match_ref", "tcam_match_cuda", "tcam_match_plain",
    "tcam_match_bits_cuda", "tcam_match_bits_ref", "pack_divisions",
    "pack_planes", "pack_words", "pack_planes_cuda", "pack_words_cuda",
    "words_per_division",
    "tcam_match_packed_cuda", "tcam_match_packed_plain",
    "tcam_match_packed_bits_cuda", "tcam_match_packed_bits_ref",
    "packed_division_major",
    "BANKED_ENGINES", "BankedOperands", "prepare_banked", "run_banked",
    "tcam_match_banked", "tcam_match_banked_cuda", "tcam_match_banked_plain",
    "tcam_match_banked_bits_cuda",
    "tcam_match_banked_ref",
]
