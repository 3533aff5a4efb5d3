"""Public TCAM-match ops: engine selection, packing, device operands, and the
serving path (``tcam_infer``) that ``DT2CAM.infer`` and the server use.

Engines:
  'mxu'    — bitplane kernel (tcam_match.py, csrc/tcam_match.cu) on planes
             packed once per layout, division-major; handles every cell
             state incl. SAF-induced CELL_MM.  The name is the JAX package's,
             kept so that an engine request means the same thing in both
             packages.
  'packed' — bit-packed popcount kernel (tcam_packed.py, csrc/tcam_packed.cu)
             on val/care words packed once per layout, division-major, in
             the same format; requires S % 32 == 0 and no CELL_MM cells.
  'ref'    — the plain PyTorch oracle (ref.py), on whichever device is asked.
  'auto'   — packed when legal, else mxu.

All engines share the contract: inputs are the *padded search words* from
``TCAMLayout.pad_inputs`` (decoder bit + encoded features + padding) and the
layout's cell grid; outputs are (survive, evals) as defined in ref.py.  The
kernels mask ragged batch and row edges themselves, so nothing is padded to
block multiples.  On the card both kernels' search words are packed per
call by the pack kernel (``pack_words_cuda``), never by a plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core.energy import DEFAULT_HW, HardwareParams, f_max, t_cwd
from ..core.lut import CELL_MM, bitplanes
from ..core.simulate import SimResult, sense_voltage
from ..core.synth import TCAMLayout
from ..device import DeviceLike, resolve_device
from .ref import tcam_match_ref
from .tcam_match import pack_planes_cuda, tcam_match_bits_cuda
from .tcam_packed import tcam_match_packed_bits_cuda

__all__ = ["tcam_match", "tcam_infer", "sa_kmax", "select_engine",
           "finalize_result", "ENGINES", "MatchOperands", "prepare_match",
           "run_match"]

ENGINES = ("auto", "mxu", "packed", "ref")

ArrayLike = Union[np.ndarray, torch.Tensor]


def select_engine(cells: np.ndarray, s: int, engine: str = "auto") -> str:
    """Resolve an engine request against the layout's legality constraints.

    'auto' picks 'packed' (8x fewer bytes per cell than the uint8 bitplanes)
    when legal — S % 32 == 0 and no SAF-induced CELL_MM cells
    (unrepresentable in packed bitplanes) — else 'mxu'.  An explicit illegal
    'packed' request raises.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    has_mm = bool(np.any(np.asarray(cells) == CELL_MM))
    packed_ok = s % 32 == 0 and not has_mm
    if engine == "auto":
        return "packed" if packed_ok else "mxu"
    if engine == "packed" and not packed_ok:
        raise ValueError("packed engine needs S % 32 == 0 and no CELL_MM cells")
    return engine


def _on(a: ArrayLike, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype).contiguous()


@dataclasses.dataclass(frozen=True)
class MatchOperands:
    """One layout's device-resident match operands for a resolved engine.
    For the two kernels, ``a`` is (D, R, 2·SW) int32 words packed on the
    device (``pack_planes_cuda``), ``b`` None and ``kmax`` transposed to
    (D, R): for 'mxu' the planes is0 then is1 per (division, row), for
    'packed' ``vc``, val = is1 then care = is0 | is1.  For 'ref' the uint8
    planes ``a = is0, b = is1`` with ``kmax`` (R, D) int32."""

    engine: str
    s: int
    a: torch.Tensor
    b: Optional[torch.Tensor]
    kmax: torch.Tensor


def prepare_match(
    cells: np.ndarray,
    s: int,
    kmax: Optional[ArrayLike] = None,
    *,
    engine: str = "auto",
    device: DeviceLike = None,
) -> MatchOperands:
    """Resolve the engine and move the layout's operands to the device once,
    so repeated batches (the server) copy only their search words."""
    dev = resolve_device(device)
    cells = np.asarray(cells)
    r, w = cells.shape
    if w % s:
        raise ValueError(f"layout width {w} is not a multiple of S={s}")
    engine = select_engine(cells, s, engine)
    km = (torch.zeros((r, w // s), dtype=torch.int32, device=dev)
          if kmax is None else _on(kmax, torch.int32, dev))
    is0, is1 = bitplanes(cells)
    if engine == "ref":
        return MatchOperands(engine=engine, s=s, a=_on(is0, torch.uint8, dev),
                             b=_on(is1, torch.uint8, dev), kmax=km)
    p0, p1 = (is0, is1) if engine == "mxu" else (is1, is0 | is1)
    words = pack_planes_cuda(_on(p0, torch.uint8, dev)[None],
                             _on(p1, torch.uint8, dev)[None], s=s)
    return MatchOperands(engine=engine, s=s, a=words[0], b=None,
                         kmax=km.t().contiguous())


def run_match(ops: MatchOperands, xpad: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, W) uint8 padded search words on the operands' device ->
    (survive, evals), both (B, R) int32."""
    if ops.engine == "packed":
        return tcam_match_packed_bits_cuda(xpad, ops.a, ops.kmax, s=ops.s)
    if ops.engine == "mxu":
        return tcam_match_bits_cuda(xpad, ops.a, ops.kmax, s=ops.s)
    return tcam_match_ref(xpad, ops.a, ops.b, ops.s, ops.kmax)


def tcam_match(
    cells: np.ndarray,              # (R, W) int8 cell states (layout.cells)
    xpad: ArrayLike,                # (B, W) padded search words {0,1}
    s: int,
    kmax: Optional[ArrayLike] = None,   # (R, D) int32
    *,
    engine: str = "auto",
    device: DeviceLike = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match search words against a tiled TCAM; returns (survive, evals),
    both (B, R) int32 on ``device``, selective-precharge semantics (see
    ref.py)."""
    dev = resolve_device(device)
    ops = prepare_match(cells, s, kmax, engine=engine, device=dev)
    return run_match(ops, _on(xpad, torch.uint8, dev))


def sa_kmax(
    layout: TCAMLayout,
    sa_offsets: np.ndarray,       # (R, D) sampled SA V_ref offsets
    hw: HardwareParams = DEFAULT_HW,
) -> np.ndarray:
    """Lower analog SA-variability to an integer mismatch tolerance:
    row r (division d) senses 'match' iff V_ml(mism) > V_ref(d) + offset[r,d];
    V_ml is monotone decreasing in the mismatch count, so the analog decision
    equals ``mism <= kmax[r, d]`` with kmax = #{k : V(k) > thresh} - 1.

    kmax = -1 encodes 'always mismatch' (offset pushed V_ref above V_fm);
    ideal hardware is kmax = 0 everywhere.
    """
    s, n_cwd = layout.s, layout.n_cwd
    rows = layout.cells.shape[0]
    used = 1 + layout.width
    n_eff = np.array(
        [max(0, min((d + 1) * s, used) - d * s) for d in range(n_cwd)], np.int64
    )
    # V(k) for k = 0..S per division (n_eff varies only in the last division)
    ks = np.arange(s + 1)
    kmax = np.zeros((rows, n_cwd), np.int64)
    for d_i in range(n_cwd):
        if n_eff[d_i] == 0:
            kmax[:, d_i] = s  # fully masked division: always matches
            continue
        v = sense_voltage(ks, np.full_like(ks, n_eff[d_i]), s, hw)  # (S+1,)
        v_fm = v[0]
        v_1mm = sense_voltage(np.array([1]), np.array([n_eff[d_i]]), s, hw)[0]
        v_ref = 0.5 * (v_fm + v_1mm)
        thresh = v_ref + sa_offsets[:, d_i]          # (R,)
        kmax[:, d_i] = (v[None, :] > thresh[:, None]).sum(axis=1) - 1
    return kmax.astype(np.int32)


def _finalize(survive: torch.Tensor, evals: torch.Tensor,
              classes: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Per search word, on the device: prediction, first surviving row (-1
    when none), survivor count and active evaluations.  ``argmax`` returns
    the first maximum, so with several survivors the lowest row wins."""
    n_survivors = survive.sum(dim=1, dtype=torch.int32)
    first = torch.argmax(survive, dim=1).to(torch.int32)
    hit = n_survivors > 0
    survivors = torch.where(hit, first, -1)
    preds = torch.where(hit, classes[survivors.clamp(min=0).long()], 0)
    active_evals = evals.sum(dim=1, dtype=torch.int64)
    return preds.to(torch.int32), survivors, n_survivors, active_evals


def finalize_result(
    layout: TCAMLayout,
    preds: np.ndarray,
    survivors: np.ndarray,
    n_survivors: np.ndarray,
    active_evals: np.ndarray,
    *,
    hw: HardwareParams = DEFAULT_HW,
    selective_precharge: bool = True,
) -> SimResult:
    """Assemble the kernel outputs into a ``SimResult``.

    Energy/latency/throughput use the exact float64 formulas of the numpy
    oracle (``core.simulate.simulate``) on the integer activity counts, on
    the host, so the result is bit-identical to the oracle on ideal hardware
    — not merely numerically close.
    """
    b = preds.shape[0]
    if selective_precharge:
        active = np.asarray(active_evals).astype(np.int64)
    else:
        active = np.full(b, layout.cells.shape[0] * layout.n_cwd, np.int64)
    energy = active.astype(np.float64) * hw.e_row + hw.e_mem
    fm = f_max(layout.s, hw)
    return SimResult(
        predictions=np.asarray(preds).astype(np.int32),
        survivors=np.asarray(survivors).astype(np.int32),
        n_survivors=np.asarray(n_survivors).astype(np.int32),
        active_evals=active,
        energy_per_dec=energy,
        latency_s=layout.n_cwd * t_cwd(layout.s, hw) + hw.t_mem,
        throughput_seq=fm / layout.n_cwd,
        throughput_pipe=fm / hw.pipeline_ii_cycles,
        s=layout.s,
        n_cwd=layout.n_cwd,
        n_rwd=layout.n_rwd,
    )


def tcam_infer(
    layout: TCAMLayout,
    xbits: np.ndarray,
    *,
    hw: HardwareParams = DEFAULT_HW,
    kmax: Optional[np.ndarray] = None,
    engine: str = "auto",
    selective_precharge: bool = True,
    device: DeviceLike = None,
) -> SimResult:
    """Encoded inputs -> ``SimResult``, with the match on ``device``.
    Functionally identical to ``core.simulate.simulate`` (tested bit-exact).
    """
    dev = resolve_device(device)
    xpad = layout.pad_inputs(np.asarray(xbits, np.uint8))
    survive, evals = tcam_match(layout.cells, xpad, layout.s, kmax,
                                engine=engine, device=dev)
    out = _finalize(survive, evals, _on(layout.classes, torch.int32, dev))
    preds, survivors, n_survivors, active = (t.cpu().numpy() for t in out)
    return finalize_result(
        layout, preds, survivors, n_survivors, active,
        hw=hw, selective_precharge=selective_precharge,
    )
