"""Build, load and launch the hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled on first use by
``nvcc`` into its own shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``build/kernels/`` at the repository root,
named by a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one loads at
once.  Nothing is compiled when this module is imported: the CPU tests
import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .ref import words_per_division

__all__ = ["KERNEL_SOURCES", "MATCH_PATH_LAUNCHES", "PACKED_PATH_LAUNCHES",
           "build_all", "check_banked_args", "check_bits_args",
           "check_match_args", "launch_match_bits", "launch_pack",
           "launch_packed_bits", "load_kernel", "match_path", "packed_path"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
KERNEL_SOURCES = ("tcam_match", "tcam_packed")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of the bitplane and of the packed match kernel by path: "tiled"
# (S <= 128, the shared-memory tiled kernel) or "any" (wider divisions).
MATCH_PATH_LAUNCHES = {"tiled": 0, "any": 0}
PACKED_PATH_LAUNCHES = {"tiled": 0, "any": 0}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish(job: tuple[Path, Path, subprocess.Popen]) -> str:
    lib, tmp, proc = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {lib.name}:\n{out}")
    os.replace(tmp, lib)      # atomic: a concurrent reader never sees half
    return out


def build_all() -> dict[str, str]:
    """Compile every kernel source that has no current library, all nvcc
    processes at once; returns each build's compiler output (``-Xptxas -v``
    register and shared-memory report), empty for libraries already built."""
    with _lock:
        jobs = {name: _start(name) for name in KERNEL_SOURCES}
        return {name: (_finish(job) if job else "") for name, job in jobs.items()}


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if need be."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(job)
            lib = ctypes.CDLL(str(_library_path(name)))
            _loaded[name] = lib
        return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_match_args(x, a, b, kmax, *, dtype: torch.dtype, names: tuple,
                     words_per_division: int) -> torch.device:
    """Shared argument checks of the two match wrappers; returns the device."""
    dev = x.device
    for t, n in zip((x, a, b), names):
        _check(t, n, dtype, 2, dev)
    _check(kmax, "kmax", torch.int32, 2, dev)
    (_, w), (r, w_a) = x.shape, a.shape
    if w_a != w or b.shape != a.shape:
        raise ValueError(
            f"width mismatch: {names[0]} {tuple(x.shape)}, {names[1]} "
            f"{tuple(a.shape)}, {names[2]} {tuple(b.shape)}"
        )
    if words_per_division <= 0 or w % words_per_division:
        raise ValueError(f"width {w} is not a multiple of {words_per_division}")
    if tuple(kmax.shape) != (r, w // words_per_division):
        raise ValueError(
            f"kmax shape {tuple(kmax.shape)} != {(r, w // words_per_division)}"
        )
    return dev


def check_banked_args(x, is0, is1, kmax, s: int) -> torch.device:
    """Argument checks of the banked match wrapper: x (G, B, W), is0 and
    is1 (G, R, W) uint8, kmax (G, R, W // s) int32; returns the device."""
    dev = x.device
    for t, n in zip((x, is0, is1), ("xbits", "is0", "is1")):
        _check(t, n, torch.uint8, 3, dev)
    _check(kmax, "kmax", torch.int32, 3, dev)
    (g, _, w), (g_p, r, w_p) = x.shape, is0.shape
    if (g_p, w_p) != (g, w) or is1.shape != is0.shape:
        raise ValueError(
            f"bank or width mismatch: xbits {tuple(x.shape)}, is0 "
            f"{tuple(is0.shape)}, is1 {tuple(is1.shape)}"
        )
    if s <= 0 or w % s:
        raise ValueError(f"width {w} is not a multiple of {s}")
    if tuple(kmax.shape) != (g, r, w // s):
        raise ValueError(f"kmax shape {tuple(kmax.shape)} != {(g, r, w // s)}")
    return dev


def check_bits_args(x, planes, kmax_t, s: int,
                    name: str = "planes") -> torch.device:
    """Argument checks of the packed-operand entries: x (G, B, W) uint8,
    ``name`` (the bitplane kernel's planes or the packed kernel's vc)
    (G, D, R, 2·SW) and kmax_t (G, D, R) int32, W = D·s; returns the
    device."""
    dev = x.device
    _check(x, "xbits", torch.uint8, 3, dev)
    _check(planes, name, torch.int32, 4, dev)
    _check(kmax_t, "kmax_t", torch.int32, 3, dev)
    g, _, w = x.shape
    if s <= 0 or w % s:
        raise ValueError(f"width {w} is not a multiple of {s}")
    d, sw = w // s, words_per_division(s)
    if planes.shape[:2] != (g, d) or planes.shape[3] != 2 * sw:
        raise ValueError(f"{name} shape {tuple(planes.shape)} != "
                         f"{(g, d, 'R', 2 * sw)}")
    if tuple(kmax_t.shape) != (g, d, planes.shape[2]):
        raise ValueError(f"kmax_t shape {tuple(kmax_t.shape)} != "
                         f"{(g, d, planes.shape[2])}")
    return dev


def _launch(fn_name: str, lib_name: str, out_shape: tuple, ptrs: tuple,
            ints: tuple, device: torch.device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the two int32 outputs and launch ``fn_name(*ptrs, survive,
    evals, *ints, stream)`` on the current stream; raise with CUDA's
    message if the launch failed."""
    survive = torch.empty(out_shape, dtype=torch.int32, device=device)
    evals = torch.empty_like(survive)
    lib = load_kernel(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = ([ctypes.c_void_p] * (len(ptrs) + 2)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(lib, fn_name,
              fn(*ptrs, survive.data_ptr(), evals.data_ptr(), *ints, stream))
    return survive, evals


def _raise_on(lib: ctypes.CDLL, fn_name: str, rc: int) -> None:
    if rc != 0:
        lib.dt2cam_error_string.restype = ctypes.c_char_p
        msg = lib.dt2cam_error_string(ctypes.c_int(rc)).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({rc})")


def launch_pack(a: torch.Tensor, b, s: int, rows_pad: int) -> torch.Tensor:
    """Pack (G, rows, W) uint8 {0,1} at one bit per cell, division-major:
    ``b is None`` gives the search words (G, D, rows_pad, SW), else the
    planes of a and b (G, D, rows, 2·SW), int32 bit patterns."""
    g, rows, w = a.shape
    sw = words_per_division(s)
    shape = ((g, w // s, rows_pad, sw) if b is None
             else (g, w // s, rows, 2 * sw))
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    lib = load_kernel("tcam_match")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if b is None:
        fn_name, ptrs, ints = ("dt2cam_pack_words", (a.data_ptr(),),
                               (g, rows, rows_pad, w, s))
    else:
        fn_name, ptrs, ints = ("dt2cam_pack_planes",
                               (a.data_ptr(), b.data_ptr()), (g, rows, w, s))
    fn = getattr(lib, fn_name)
    fn.argtypes = ([ctypes.c_void_p] * (len(ptrs) + 1)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _raise_on(lib, fn_name, fn(*ptrs, out.data_ptr(), *ints, stream))
    return out


def _path(lib_name: str, fn_name: str, s: int) -> str:
    tiled = getattr(load_kernel(lib_name), fn_name)
    tiled.argtypes, tiled.restype = [ctypes.c_int], ctypes.c_int
    return "tiled" if tiled(s) else "any"


def match_path(s: int) -> str:
    """The bitplane kernel's path for division width ``s``, as the kernel's
    own dispatch (``dt2cam_match_bits_tiled``) chooses it."""
    return _path("tcam_match", "dt2cam_match_bits_tiled", s)


def packed_path(s: int) -> str:
    """The packed kernel's path for division width ``s``, as its dispatch
    (``dt2cam_packed_bits_tiled``) chooses it."""
    return _path("tcam_packed", "dt2cam_packed_bits_tiled", s)


def launch_match_bits(xw: torch.Tensor, planes: torch.Tensor,
                      kmax_t: torch.Tensor, n_b: int, s: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the bitplane kernel on packed operands, xw (G, D, Bp, SW),
    planes (G, D, R, 2·SW), kmax_t (G, D, R); (G, n_b, R) int32 outputs."""
    g, d, bp, _ = xw.shape
    n_r = planes.shape[2]
    out = _launch("dt2cam_tcam_match_bits", "tcam_match", (g, n_b, n_r),
                  (xw.data_ptr(), planes.data_ptr(), kmax_t.data_ptr()),
                  (g, n_b, bp, n_r, d, s), xw.device)
    MATCH_PATH_LAUNCHES[match_path(s)] += 1
    return out


def launch_packed_bits(xw: torch.Tensor, vc: torch.Tensor,
                       kmax_t: torch.Tensor, n_b: int, s: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the packed kernel on division-major operands, xw (D, Bp, SW),
    vc (D, R, 2·SW), kmax_t (D, R); (n_b, R) int32 outputs.  The kernel
    first groups each tile's equal search words, into scratch allocated
    here."""
    d, bp, _ = xw.shape
    n_r = vc.shape[1]
    classes = torch.empty((d, -(-n_b // 64) * 64), dtype=torch.int64,
                          device=xw.device)
    out = _launch("dt2cam_tcam_packed_bits", "tcam_packed", (n_b, n_r),
                  (xw.data_ptr(), vc.data_ptr(), kmax_t.data_ptr(),
                   classes.data_ptr()), (n_b, bp, n_r, d, s), xw.device)
    PACKED_PATH_LAUNCHES[packed_path(s)] += 1
    return out
