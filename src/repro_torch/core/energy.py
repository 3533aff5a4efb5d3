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
           "bank_figures", "forest_figures"]


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
