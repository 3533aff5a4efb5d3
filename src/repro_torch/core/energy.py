"""ReCAM analog hardware model (paper §II.C, Eqns 5-11, Tables III & IV).

All analog physics of the resistive TCAM live here: match-line RC dynamics,
dynamic range, optimal sensing time, operating frequency, per-row energy and
the area model.  The *functional* match/active-row counts are produced by the
simulator/kernels; this module converts them into Joules/seconds/m².

Calibration notes: the paper's SPICE-derived constants
(E_sa, T_sa, τ_pchg, area cells) are not published.  They are calibrated here
so that the model reproduces the paper's own anchors exactly:
  * Table IV: D_cap limits {0.2,0.3,0.4,0.5,0.6} V -> max cells/row
    {154, 86, 53, 33, 21} (from Eqn 6 with Table III resistances),
  * Eqn 10: f_max = 1 GHz at S = 128,
  * Table VI: 0.098 nJ/dec on the 2000×2048 traffic LUT at S=128,
    area 0.07 mm², area/bit 0.017 µm²/bit.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["HardwareParams", "DEFAULT_HW", "dynamic_range", "max_cells_per_row",
           "t_opt", "t_cwd", "f_max", "choose_tile_size", "TABLE_IV",
           "bank_figures", "forest_figures", "write_energy",
           "reprogram_figures", "SenseMargins", "sensing_margins",
           "sensing_margins_ref", "mismatch_probability",
           "mismatch_probability_ref"]


@dataclasses.dataclass(frozen=True)
class HardwareParams:
    # --- Table III: 16nm predictive technology model ---
    r_lrs: float = 5e3         # Low Resistance State  [Ω]
    r_hrs: float = 2.5e6       # High Resistance State [Ω]
    r_on: float = 15e3         # ON  transistor        [Ω]
    r_off: float = 24.25e6     # OFF transistor        [Ω]
    c_in: float = 50e-15       # sensing capacitance   [F]
    v_dd: float = 1.0          # supply                [V]
    # --- calibrated SPICE-derived constants ---
    t_sa: float = 0.20e-9      # double-tail SA sensing time [s]
    tau_pchg: float = 0.054e-9 # precharge time constant     [s]
    t_mem: float = 1.0e-9      # 1T1R class read (parallel bits) [s]
    e_sa: float = 2.4e-15      # SA energy per evaluation    [J]
    e_tcam_eta: float = 0.90   # fraction of C·V² dissipated per active row eval
    e_mem: float = 5.0e-15     # 1T1R + SA2 class read energy [J]
    pipeline_ii_cycles: int = 3  # P/E/SA initiation interval (Fig 4) in cycles
    # --- area model cells (16nm), calibrated to Table VI ---
    a_2t2r: float = 0.0140e-12   # [m²] TCAM cell
    a_sa: float = 0.15e-12       # [m²] double-tail SA
    a_dff: float = 0.04e-12      # [m²] tag D-flipflop
    a_sp: float = 0.03e-12       # [m²] selective-precharge circuit (Fig 5)
    a_1t1r: float = 0.007e-12    # [m²] class storage cell
    a_sa2: float = 0.15e-12      # [m²] class read SA ([32])
    # --- programming (write) model: per resistive element -----------------
    # ReRAM-class constants (RETENTION's endurance lever): a SET pulse moves
    # an element HRS -> LRS, a RESET pulse LRS -> HRS; each pulse costs
    # energy, takes t_prog, and consumes one endurance cycle of the element.
    e_set: float = 1.0e-12       # SET pulse energy   [J]
    e_reset: float = 1.5e-12     # RESET pulse energy [J] (higher V/ longer)
    t_prog: float = 10.0e-9      # program pulse width [s]
    endurance_writes: float = 1.0e6  # element program cycles before failure

    # Effective 2T2R cell resistances: the searched branch in series with its
    # transistor, in parallel with the idle branch through the OFF transistor.
    @property
    def r_cell_match(self) -> float:
        return _par(self.r_hrs + self.r_on, self.r_lrs + self.r_off)

    @property
    def r_cell_mismatch(self) -> float:
        return _par(self.r_lrs + self.r_on, self.r_hrs + self.r_off)

    @property
    def e_row(self) -> float:
        """Eqn 7: E_row^active = E_TCAM + E_sa, per active row per division."""
        return self.e_tcam_eta * self.c_in * self.v_dd**2 + self.e_sa


def _par(a: float, b: float) -> float:
    return a * b / (a + b)


DEFAULT_HW = HardwareParams()


def _row_resistances(n_cells: int, hw: HardwareParams) -> tuple[float, float]:
    """(R_fm, R_1mm) for a row of n_cells: full match = n parallel matching
    cells; one-mismatch = n-1 matching ∥ 1 mismatching."""
    if n_cells < 2:
        raise ValueError("row needs >= 2 cells")
    r_fm = hw.r_cell_match / n_cells
    r_1mm = _par(hw.r_cell_match / (n_cells - 1), hw.r_cell_mismatch)
    return r_fm, r_1mm


def dynamic_range(n_cells: int, hw: HardwareParams = DEFAULT_HW) -> float:
    """Eqn 6: D_cap at t = T_opt for a row of n_cells."""
    r_fm, r_1mm = _row_resistances(n_cells, hw)
    g = r_1mm / r_fm  # γ < 1
    return hw.v_dd * g ** (g / (1.0 - g)) * (1.0 - g)


def max_cells_per_row(d_limit: float, hw: HardwareParams = DEFAULT_HW) -> int:
    """Largest row size whose dynamic range still meets d_limit (Table IV).

    D(n) is monotonically decreasing in n; the paper reports the value to the
    nearest integer of the continuous crossing, which we match by scanning and
    returning round() of the interpolated crossing.
    """
    lo, hi = 2, 4096
    if dynamic_range(hi, hw) > d_limit:
        return hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if dynamic_range(mid, hw) >= d_limit:
            lo = mid
        else:
            hi = mid
    # interpolate the real-valued crossing between lo and hi for round-to-nearest
    d_lo, d_hi = dynamic_range(lo, hw), dynamic_range(hi, hw)
    frac = (d_lo - d_limit) / max(d_lo - d_hi, 1e-12)
    return int(round(lo + frac))


TABLE_IV = {0.2: 128, 0.3: 64, 0.4: 32, 0.5: 32, 0.6: 16}  # D_limit -> chosen S


def choose_tile_size(d_limit: float, hw: HardwareParams = DEFAULT_HW) -> int:
    """Power-of-two S not exceeding the max cells/row for d_limit (Table IV)."""
    n = max_cells_per_row(d_limit, hw)
    s = 1
    while s * 2 <= n:
        s *= 2
    return s


def t_opt(n_cells: int, hw: HardwareParams = DEFAULT_HW) -> float:
    """Eqn 8: optimal match-line sensing time for a row of n_cells."""
    r_fm, r_1mm = _row_resistances(n_cells, hw)
    return hw.c_in * math.log(r_fm / r_1mm) * (r_fm * r_1mm) / (r_fm - r_1mm)


def t_cwd(s: int, hw: HardwareParams = DEFAULT_HW) -> float:
    """Eqn 9: per-column-division latency = 3·τ_pchg + T_opt + T_sa."""
    return 3.0 * hw.tau_pchg + t_opt(s, hw) + hw.t_sa


def f_max(s: int, hw: HardwareParams = DEFAULT_HW) -> float:
    """Eqn 10: operating frequency 1 / max(T_cwd, T_mem)."""
    return 1.0 / max(t_cwd(s, hw), hw.t_mem)


# ---------------------------------------------------------------------------
# Multi-bank (forest) figures
# ---------------------------------------------------------------------------

def bank_figures(
    layout,
    hw: HardwareParams = DEFAULT_HW,
    *,
    mean_active_evals: float | None = None,
) -> dict:
    """Per-bank energy / latency / area figures for one ``TCAMLayout``.

    Duck-typed: ``layout`` only needs ``s``, ``n_cwd``, ``n_rows`` and
    ``area_m2``.  ``mean_active_evals`` (mean N_a per decision, from the
    simulator/kernels' activity trace) enables the energy-per-decision figure;
    without it the energy entry is omitted.
    """
    s, n_cwd = int(layout.s), int(layout.n_cwd)
    fm = f_max(s, hw)
    fig = {
        "s": s,
        "n_cwd": n_cwd,
        "rows": int(layout.n_rows),
        "f_max_hz": fm,
        "latency_s": n_cwd * t_cwd(s, hw) + hw.t_mem,
        "decs_seq": fm / n_cwd,
        "decs_pipe": fm / hw.pipeline_ii_cycles,
        "area_m2": float(area(hw) if callable(area := layout.area_m2) else area),
    }
    if mean_active_evals is not None:
        fig["energy_per_dec_j"] = (
            float(mean_active_evals) * hw.e_row + hw.e_mem
        )
    return fig


def forest_figures(
    layouts,
    hw: HardwareParams = DEFAULT_HW,
    *,
    mean_active_evals=None,
) -> dict:
    """Aggregate pipelined figures for a multi-bank (ensemble) deployment.

    ``layouts`` is a sequence of ``TCAMLayout``-likes (one per bank);
    ``mean_active_evals``, when given, is a matching sequence of per-bank mean
    N_a values.  Returns ``{"banks": [per-bank dicts], "aggregate": {...}}``.

    Aggregate semantics: banks run concurrently and each sustains its own
    pipelined rate, so *aggregate* dec/s is the sum over banks (raw row-match
    throughput of the chip — monotone in bank count), while the *ensemble*
    rate (complete forest decisions, which need every bank's vote) is the
    slowest bank's rate and the ensemble latency is the slowest bank's
    latency.  Area and energy per ensemble decision sum across banks.
    """
    layouts = list(layouts)
    if not layouts:
        raise ValueError("forest_figures needs at least one bank layout")
    if mean_active_evals is None:
        mean_active_evals = [None] * len(layouts)
    else:
        mean_active_evals = list(mean_active_evals)
        if len(mean_active_evals) != len(layouts):
            raise ValueError(
                f"mean_active_evals has {len(mean_active_evals)} entries for "
                f"{len(layouts)} banks"
            )
    banks = [
        bank_figures(lay, hw, mean_active_evals=ev)
        for lay, ev in zip(layouts, mean_active_evals)
    ]
    agg = {
        "n_banks": len(banks),
        "decs_pipe": sum(b["decs_pipe"] for b in banks),
        "ensemble_decs_pipe": min(b["decs_pipe"] for b in banks),
        "latency_s": max(b["latency_s"] for b in banks),
        "area_m2": sum(b["area_m2"] for b in banks),
    }
    if all("energy_per_dec_j" in b for b in banks):
        agg["energy_per_dec_j"] = sum(b["energy_per_dec_j"] for b in banks)
    return {"banks": banks, "aggregate": agg}


# ---------------------------------------------------------------------------
# Programming (write) figures — the lifecycle subsystem's energy model
# ---------------------------------------------------------------------------

def write_energy(
    n_set: int, n_reset: int, hw: HardwareParams = DEFAULT_HW
) -> float:
    """Modelled energy [J] of a programming pass: per-element pulse counts
    times the calibrated SET/RESET pulse energies."""
    return float(n_set) * hw.e_set + float(n_reset) * hw.e_reset


def reprogram_figures(plan, hw: HardwareParams = DEFAULT_HW) -> dict:
    """Energy / time / endurance figures for one write plan.

    Duck-typed: ``plan`` needs ``kind``, ``n_cells_written``, ``n_set``,
    ``n_reset``, ``class_set``, ``class_reset`` and ``rows_touched`` (a
    ``lifecycle.WritePlan``).  Pulses are modelled as serialized
    through one program driver (worst case): time = total pulses × t_prog.
    """
    n_set = int(plan.n_set) + int(plan.class_set)
    n_reset = int(plan.n_reset) + int(plan.class_reset)
    pulses = n_set + n_reset
    return {
        "kind": plan.kind,
        "cells_written": int(plan.n_cells_written),
        "rows_touched": int(plan.rows_touched),
        "set_pulses": n_set,
        "reset_pulses": n_reset,
        "pulses": pulses,
        "energy_j": write_energy(n_set, n_reset, hw),
        "time_s": pulses * hw.t_prog,
        "endurance_cycles_consumed": pulses,
    }


# ---------------------------------------------------------------------------
# Sensing-margin analysis — the degradation subsystem's detection model
# ---------------------------------------------------------------------------
# The SA references are trimmed at manufacture to the *nominal* per-division
# V_ref (midpoint of V_fm / V_1mm for ideal Table-III resistances — the same
# convention the simulator's sa_sigma model uses).  As cells drift, the
# match-line voltages move while V_ref stays fixed; the distance between them
# is the sensing margin, and a chip is due for a scrub when it shrinks.
#
# ``sensing_margins`` runs as float64 tensor ops on the grids' device, all
# divisions in one reshaped (rows, divisions, S) pass; ``sensing_margins_ref``
# is the copied numpy loop over divisions.  The tensor version sums each
# division's conductances in numpy's pairwise order (``_pairwise_sum``), so
# rows numpy finds tied stay tied and the rows a scrub selects, worst first,
# come in the same order; its ``exp`` may still differ from numpy's by an
# ulp, so the margins agree to rounding, not bit for bit.

import numpy as np  # noqa: E402  (the hardware model above is numpy-free)
import torch  # noqa: E402

from ..device import DeviceLike, resolve_device  # noqa: E402

_erfc = np.vectorize(math.erfc, otypes=[np.float64])


@dataclasses.dataclass(frozen=True)
class SenseMargins:
    """Worst-case (over column divisions) per-row sensing margins [V].

    ``margin_match``: V_ml(full match) − V_ref — headroom before a fully
    matching row misreads as a mismatch (drifted-up LRS / drifted-down HRS
    erode it).  ``margin_mismatch``: V_ref − V_ml(worst single mismatch) —
    headroom before a one-mismatch row misreads as a match.  Either going
    negative means the row *functionally* misbehaves even with ideal SAs.
    Host (numpy) arrays, whichever device computed them.
    """

    margin_match: np.ndarray      # (rows,) [V]
    margin_mismatch: np.ndarray   # (rows,) [V]
    v_ref: np.ndarray             # (n_cwd,) nominal per-division reference [V]

    @property
    def margin(self) -> np.ndarray:
        """(rows,) overall margin: min of the two failure directions."""
        return np.minimum(self.margin_match, self.margin_mismatch)

    def summary(self) -> dict:
        m = self.margin
        return {
            "min_v": float(m.min()) if m.size else float("nan"),
            "mean_v": float(m.mean()) if m.size else float("nan"),
            "rows_negative": int((m < 0).sum()),
        }


def _ml_voltage(g_row, s: int, hw: HardwareParams):
    """Match-line voltage at the sensing instant for per-row conductance
    g_row [S]: v_dd · exp(−T_opt(S) · g / C_in)  (simulate.sense_voltage
    with R_row = 1/g; reimplemented here because simulate imports energy).
    numpy in, numpy out; a tensor is divided by C_in as a device tensor, an
    IEEE division on every device."""
    if torch.is_tensor(g_row):
        c_in = torch.tensor(hw.c_in, dtype=torch.float64, device=g_row.device)
        return hw.v_dd * torch.exp(-t_opt(s, hw) * g_row / c_in)
    return hw.v_dd * np.exp(-t_opt(s, hw) * np.asarray(g_row) / hw.c_in)


def _pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of numpy's float64 ``sum``
    (``pairwise_sum`` in numpy's ``loops_utils.h.src``): under 8 terms one
    running sum from -0.0; up to 128, eight running lanes combined as
    ((0+1)+(2+3))+((4+5)+(6+7)), then the remainder; above, the two halves
    (split at a multiple of 8) summed alike and added."""
    n = a.shape[-1]
    if n < 8:
        res = torch.full(a.shape[:-1], -0.0, dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[..., i]
        return res
    if n <= 128:
        m = n - n % 8
        r = a[..., :8].clone()
        for i in range(8, m, 8):
            r += a[..., i:i + 8]
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for i in range(m, n):
            res = res + a[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sum(a[..., :n2]) + _pairwise_sum(a[..., n2:])


def _division_refs(cols: int, s: int, used: int, hw: HardwareParams):
    """Per division: its real (unmasked) column count and its nominal
    reference V_ref (ideal resistances, n_eff = real; 0 where real = 0)."""
    n_cwd = max(1, -(-cols // s))
    reals = np.zeros(n_cwd, np.int64)
    v_refs = np.zeros(n_cwd)
    for d in range(n_cwd):
        lo = d * s
        real = max(0, min((d + 1) * s, used, cols) - lo)
        if real == 0:
            continue
        reals[d] = real
        g_fm_nom = real / hw.r_cell_match
        g_1mm_nom = (real - 1) / hw.r_cell_match + 1.0 / hw.r_cell_mismatch
        v_refs[d] = 0.5 * (_ml_voltage(g_fm_nom, s, hw)
                           + _ml_voltage(g_1mm_nom, s, hw))
    return reals, v_refs


def sensing_margins(
    r_match,
    r_mismatch,
    *,
    s: int,
    used: int,
    hw: HardwareParams = DEFAULT_HW,
    determinate=None,
    device: DeviceLike = None,
) -> SenseMargins:
    """Per-row sensing margins of a (possibly drifted) cell grid, as float64
    tensor ops.

    ``r_match`` / ``r_mismatch`` are (rows, cols) per-cell effective
    resistances in the match / mismatch search state (e.g. from
    ``DriftModel.cell_resistances``; at zero drift every determinate cell sits
    at ``hw.r_cell_match`` / ``hw.r_cell_mismatch`` and the margins equal the
    design margins).  ``used`` = 1 + layout.width: columns at or beyond it are
    masked (OFF-OFF) and excluded, matching the simulator.  ``determinate``
    optionally masks which cells can actually mismatch (CELL_X never does);
    by default every unmasked cell is considered.  Tensors are used on their
    own device; numpy grids go to ``device`` (None = the card).
    """
    if not torch.is_tensor(r_match):
        dev = resolve_device(device)
    else:
        dev = r_match.device
    r_match = torch.as_tensor(r_match, dtype=torch.float64, device=dev)
    r_mismatch = torch.as_tensor(r_mismatch, dtype=torch.float64, device=dev)
    if r_match.shape != r_mismatch.shape or r_match.ndim != 2:
        raise ValueError("r_match / r_mismatch must be equal-shape 2-D grids")
    rows, cols = r_match.shape
    reals, v_refs = _division_refs(cols, s, used, hw)
    n_cwd = v_refs.shape[0]
    live = np.flatnonzero(reals > 0)
    if live.size == 0:
        inf = np.full(rows, np.inf)
        return SenseMargins(margin_match=inf, margin_mismatch=inf.copy(),
                            v_ref=v_refs)
    pad = n_cwd * s - cols
    real = torch.arange(cols, device=dev) < min(used, cols)
    det = real.expand(rows, cols)
    if determinate is not None:
        det = torch.as_tensor(determinate, device=dev).to(torch.bool) & det

    def divisions(t: torch.Tensor) -> torch.Tensor:
        """(rows, cols) -> (rows, D, S), zero columns past ``cols``."""
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        return t.view(rows, n_cwd, s)

    # every division at once; unmasked columns only, each division's real
    # columns summed in numpy's order (one group per real-column count)
    g_cells = divisions(torch.where(real, torch.reciprocal(r_match), 0.0))
    g_fm = torch.zeros((rows, n_cwd), dtype=torch.float64, device=dev)
    for n_real in np.unique(reals[live]):
        idx = torch.from_numpy(np.flatnonzero(reals == n_real)).to(dev)
        g_fm[:, idx] = _pairwise_sum(g_cells[:, idx, :int(n_real)])
    v_ref = torch.from_numpy(v_refs).to(dev)
    sel = torch.from_numpy(live).to(dev)
    m_match = (_ml_voltage(g_fm, s, hw) - v_ref)[:, sel].amin(dim=1)

    # worst single mismatch: the determinate cell whose match->mismatch
    # swap adds the LEAST conductance discharges the line the least and
    # sits closest to (or above) V_ref
    delta = divisions(torch.reciprocal(r_mismatch)) - g_cells
    del g_cells
    delta = torch.where(divisions(det.to(torch.uint8)) > 0, delta,
                        float("inf"))
    d_min = delta.amin(dim=2)                          # inf if none can mm
    del delta
    has_mm = torch.isfinite(d_min)
    v_1mm = _ml_voltage(torch.where(has_mm, g_fm + d_min, 0.0), s, hw)
    m_mm = torch.where(has_mm, v_ref - v_1mm, float("inf"))
    m_mismatch = m_mm[:, sel].amin(dim=1)
    return SenseMargins(margin_match=m_match.cpu().numpy(),
                        margin_mismatch=m_mismatch.cpu().numpy(),
                        v_ref=v_refs)


def sensing_margins_ref(
    r_match: np.ndarray,
    r_mismatch: np.ndarray,
    *,
    s: int,
    used: int,
    hw: HardwareParams = DEFAULT_HW,
    determinate: np.ndarray | None = None,
) -> SenseMargins:
    """``sensing_margins`` as the copied numpy loop over divisions."""
    r_match = np.asarray(r_match, dtype=np.float64)
    r_mismatch = np.asarray(r_mismatch, dtype=np.float64)
    if r_match.shape != r_mismatch.shape or r_match.ndim != 2:
        raise ValueError("r_match / r_mismatch must be equal-shape 2-D grids")
    rows, cols = r_match.shape
    n_cwd = max(1, -(-cols // s))
    if determinate is None:
        determinate = np.ones((rows, cols), dtype=bool)

    m_match = np.full(rows, np.inf)
    m_mismatch = np.full(rows, np.inf)
    v_refs = np.zeros(n_cwd)
    for d in range(n_cwd):
        lo = d * s
        real = max(0, min((d + 1) * s, used, cols) - lo)
        if real == 0:
            continue
        # nominal division references (ideal resistances, n_eff = real)
        g_fm_nom = real / hw.r_cell_match
        g_1mm_nom = (real - 1) / hw.r_cell_match + 1.0 / hw.r_cell_mismatch
        v_ref = 0.5 * (_ml_voltage(g_fm_nom, s, hw)
                       + _ml_voltage(g_1mm_nom, s, hw))
        v_refs[d] = v_ref

        g_cells = 1.0 / r_match[:, lo:lo + real]          # (rows, real)
        g_fm = g_cells.sum(axis=1)                        # all cells match
        m_match = np.minimum(m_match, _ml_voltage(g_fm, s, hw) - v_ref)

        det = determinate[:, lo:lo + real]
        delta = np.where(det, 1.0 / r_mismatch[:, lo:lo + real] - g_cells,
                         np.inf)
        d_min = delta.min(axis=1)                         # inf if none can mm
        has_mm = np.isfinite(d_min)
        if has_mm.any():
            v_1mm = _ml_voltage(g_fm[has_mm] + d_min[has_mm], s, hw)
            m_mismatch[has_mm] = np.minimum(m_mismatch[has_mm], v_ref - v_1mm)

    return SenseMargins(margin_match=m_match, margin_mismatch=m_mismatch,
                        v_ref=v_refs)


def mismatch_probability(margin, sa_sigma: float, *,
                         device: DeviceLike = None) -> torch.Tensor:
    """Probability that an SA with reference offset ~N(0, sa_sigma) misreads
    a row with the given sensing margin [V]: the Gaussian tail beyond the
    margin.  sa_sigma = 0 degenerates to a step (0 / ½ / 1).  A float64
    tensor on the margin's device (a numpy margin goes to ``device``)."""
    dev = margin.device if torch.is_tensor(margin) else resolve_device(device)
    m = torch.as_tensor(margin, dtype=torch.float64, device=dev)
    if sa_sigma < 0:
        raise ValueError(f"sa_sigma must be >= 0, got {sa_sigma}")
    if sa_sigma == 0:
        return torch.where(m > 0, 0.0,
                           torch.where(m < 0, 1.0, torch.full_like(m, 0.5)))
    scale = torch.tensor(sa_sigma * math.sqrt(2.0), dtype=torch.float64,
                         device=dev)
    return 0.5 * torch.special.erfc(m / scale)


def mismatch_probability_ref(margin, sa_sigma: float) -> np.ndarray:
    """``mismatch_probability`` as the copied numpy body."""
    m = np.asarray(margin, dtype=np.float64)
    if sa_sigma < 0:
        raise ValueError(f"sa_sigma must be >= 0, got {sa_sigma}")
    if sa_sigma == 0:
        return np.where(m > 0, 0.0, np.where(m < 0, 1.0, 0.5))
    return 0.5 * _erfc(m / (sa_sigma * math.sqrt(2.0)))
