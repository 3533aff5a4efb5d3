"""Build, load and launch the hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled on first use by
``nvcc`` into its own shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``build/kernels/`` at the repository root,
named by a hash of its source and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing is compiled when this module is
imported: the CPU tests import every module on machines without ``nvcc``.
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

__all__ = ["KERNEL_SOURCES", "build_all", "check_match_args", "launch_match",
           "load_kernel"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
KERNEL_SOURCES = ("tcam_match", "tcam_packed")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
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


def launch_match(fn_name: str, lib_name: str, x, a, b, kmax, width: int,
                 division: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the (B, R) outputs and launch one match kernel on the
    current stream; raise with CUDA's message if the launch failed."""
    n_b, n_r = x.shape[0], a.shape[0]
    survive = torch.empty((n_b, n_r), dtype=torch.int32, device=x.device)
    evals = torch.empty_like(survive)
    lib = load_kernel(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), kmax.data_ptr(),
            survive.data_ptr(), evals.data_ptr(), n_b, n_r, width, division,
            stream)
    if rc != 0:
        lib.dt2cam_error_string.restype = ctypes.c_char_p
        msg = lib.dt2cam_error_string(ctypes.c_int(rc)).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({rc})")
    return survive, evals
