"""Hardware non-idealities (paper §II.C.2, Table I, Fig 7/8).

Static mechanisms (fixed at manufacturing / write time):
  * Stuck-At-Faults: each of the two resistive elements of a 2T2R cell
    independently sticks to HRS (SA0, prob p_sa0) or LRS (SA1, prob p_sa1).
    The resulting {R1, R2} pair maps back to a cell state, including the
    pathological {LRS, LRS} = always-mismatch (Table I).
  * SA manufacturing variability: handled inside ``simulate`` (σ_sa offsets on
    V_ref of individual sense amplifiers).
  * Input encoding noise: N(0, σ_in) added to normalized features before
    encoding.

Temporal mechanisms (grow *between* writes — Pedretti et al.'s first-order
threat to CAM-resident tree inference):
  * Conductance drift: each programmed element's resistance walks away from
    its nominal state on a log-time power law ``(1 + t/t0)^ν`` with a
    per-element exponent ν (chip-persistent, sampled once like stuck faults).
  * Retention decay: an additional exponential loss ``exp(t/τ_ret)`` that
    dominates at long horizons.
  * Read disturb: every search pulse stresses the cells; accumulated reads
    add ``read_disturb_s`` equivalent stress-seconds each, so a hot row ages
    faster than a cold one.

Both fault families are *physical, persistent* chip properties: the same
elements stay stuck (``SAFMask``) and the same elements drift fastest
(``DriftModel``) no matter what is later written.  Writing a row resets its
drift clock (that is what a scrub/refresh pulse does — ``degradation``),
but never its stuck elements or its drift exponents.  ``apply_saf``
remains the one-shot convenience wrapper (sample + apply).

The drift grids live on the device: ``sample_drift`` draws the exponents on
the host with numpy (the JAX package's draws, in its order) and moves them
to the device once; ``DriftModel``'s readout and resistances are float64
tensor ops there.  The copied numpy bodies are kept as ``growth_ref``,
``readout_ref`` and ``cell_resistances_ref``, the plain versions the tests
hold the tensor ops against.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .lut import CELL_0, CELL_1, CELL_MM, CELL_X

__all__ = [
    "NonIdealSpec", "IDEAL", "SAFMask", "sample_saf", "apply_saf_mask",
    "apply_saf", "noisy_inputs", "CELL_TO_PAIR",
    "DriftSpec", "DriftModel", "sample_drift", "pin_stuck",
]


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """Temporal degradation law of one chip's resistive elements.

    An element programmed at time ``t_w`` and read ``k`` times since has
    accumulated equivalent stress time

        t_eff = (t - t_w) + read_disturb_s * k

    and its resistance has walked away from nominal by the factor

        f = (1 + t_eff / t0) ** ν_elem  *  exp(t_eff / retention_tau_s)

    LRS elements drift *up* (conductance loss, R *= f); HRS elements drift
    *down* (R /= f ** hrs_drift_scale — LRS retention loss dominates in
    ReRAM, so HRS drift is attenuated).  ν_elem is sampled once per element
    per chip (``sample_drift``): ``|N(nu, nu_sigma)|`` — the chip's weakest
    cells are persistent, exactly like its stuck elements.

    nu: mean log-time drift exponent (0 disables the power-law term).
    nu_sigma: per-element chip variability of the exponent.
    t0: drift-law reference time [s].
    retention_tau_s: exponential retention decay constant [s] (inf disables).
    read_disturb_s: equivalent stress seconds added per read of the element.
    hrs_drift_scale: attenuation of HRS drift relative to LRS drift.
    """

    nu: float = 0.0
    nu_sigma: float = 0.0
    t0: float = 1.0
    retention_tau_s: float = math.inf
    read_disturb_s: float = 0.0
    hrs_drift_scale: float = 0.5

    def __post_init__(self) -> None:
        for f in ("nu", "nu_sigma", "read_disturb_s", "hrs_drift_scale"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")
        if self.t0 <= 0:
            raise ValueError("t0 must be > 0")
        if self.retention_tau_s <= 0:
            raise ValueError("retention_tau_s must be > 0")

    @property
    def is_ideal(self) -> bool:
        return (self.nu == 0 and self.nu_sigma == 0
                and math.isinf(self.retention_tau_s))


@dataclasses.dataclass(frozen=True)
class NonIdealSpec:
    """One object grouping the paper's three non-ideality mechanisms plus
    the temporal degradation law.

    Replaces the sprawling ``p_sa0/p_sa1/sa_sigma/sigma_in`` keyword lists
    that the inference entry points used to take (the flat keywords on
    ``DT2CAM.infer`` were removed after their one-release deprecation).

    p_sa0 / p_sa1: per-resistive-element stuck-at-HRS / stuck-at-LRS fault
        probabilities (Table I).
    sa_sigma: sense-amplifier V_ref manufacturing variability σ [V].
    sigma_in: input-encoding noise σ on normalized features.
    drift: temporal drift/retention law (``DriftSpec``); None = stable cells.
    """

    p_sa0: float = 0.0
    p_sa1: float = 0.0
    sa_sigma: float = 0.0
    sigma_in: float = 0.0
    drift: Optional[DriftSpec] = None

    def __post_init__(self) -> None:
        for f in ("p_sa0", "p_sa1", "sa_sigma", "sigma_in"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")
        if self.p_sa0 + self.p_sa1 > 1.0:
            raise ValueError("p_sa0 + p_sa1 must be <= 1")
        if self.drift is not None and not isinstance(self.drift, DriftSpec):
            raise TypeError(
                f"drift must be a DriftSpec or None, got {type(self.drift)}"
            )

    @property
    def is_ideal(self) -> bool:
        return (self.p_sa0 == 0 and self.p_sa1 == 0
                and self.sa_sigma == 0 and self.sigma_in == 0
                and not self.has_drift)

    @property
    def has_saf(self) -> bool:
        return self.p_sa0 > 0 or self.p_sa1 > 0

    @property
    def has_drift(self) -> bool:
        return self.drift is not None and not self.drift.is_ideal


IDEAL = NonIdealSpec()

# cell state -> (R1 is LRS?, R2 is LRS?) — Table I encoding
CELL_TO_PAIR = {
    CELL_0: (False, True),   # {HRS, LRS}
    CELL_1: (True, False),   # {LRS, HRS}
    CELL_X: (False, False),  # {HRS, HRS}
    CELL_MM: (True, True),   # {LRS, LRS}
}
_PAIR_TO_CELL = np.zeros((2, 2), dtype=np.int8)
for _c, (_a, _b) in CELL_TO_PAIR.items():
    _PAIR_TO_CELL[int(_a), int(_b)] = _c


@dataclasses.dataclass(frozen=True)
class SAFMask:
    """Persistent per-element stuck-fault state of one physical chip.

    Four boolean arrays of the cell-grid shape; ``sa0_*`` marks elements
    stuck at HRS, ``sa1_*`` elements stuck at LRS (disjoint per element).
    """

    sa0_r1: np.ndarray
    sa1_r1: np.ndarray
    sa0_r2: np.ndarray
    sa1_r2: np.ndarray

    @property
    def shape(self) -> tuple[int, ...]:
        return self.sa0_r1.shape

    @property
    def any_fault(self) -> np.ndarray:
        """Boolean grid: cell has at least one stuck element."""
        return self.sa0_r1 | self.sa1_r1 | self.sa0_r2 | self.sa1_r2

    @property
    def n_stuck_elements(self) -> int:
        return int(self.sa0_r1.sum() + self.sa1_r1.sum()
                   + self.sa0_r2.sum() + self.sa1_r2.sum())


def _stuck_draw(
    shape: tuple[int, ...], p_sa0: float, p_sa1: float,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-element stuck state: two *independent* defect draws; when both
    fire, a fair coin picks the winner (two independent physical defects —
    whichever dominates the element is a toss-up)."""
    fire0 = rng.random(shape) < p_sa0
    fire1 = rng.random(shape) < p_sa1
    both = fire0 & fire1
    coin = rng.random(shape) < 0.5
    sa0 = (fire0 & ~fire1) | (both & coin)
    sa1 = (fire1 & ~fire0) | (both & ~coin)
    return sa0, sa1


def sample_saf(
    shape: tuple[int, ...],
    p_sa0: float,
    p_sa1: float,
    rng: np.random.Generator,
) -> SAFMask:
    """Sample one chip's persistent stuck-at fault mask.

    Each resistive element independently becomes stuck-at-HRS with prob p_sa0
    and stuck-at-LRS with prob p_sa1; if both independent defects fire on the
    same element, a 50/50 draw resolves which one dominates."""
    if p_sa0 + p_sa1 > 1.0:
        raise ValueError("p_sa0 + p_sa1 must be <= 1")
    sa0_r1, sa1_r1 = _stuck_draw(shape, p_sa0, p_sa1, rng)
    sa0_r2, sa1_r2 = _stuck_draw(shape, p_sa0, p_sa1, rng)
    return SAFMask(sa0_r1=sa0_r1, sa1_r1=sa1_r1, sa0_r2=sa0_r2, sa1_r2=sa1_r2)


def apply_saf_mask(cells: np.ndarray, mask: SAFMask) -> np.ndarray:
    """Project intended cell contents through a chip's stuck elements.

    Models a physical array write: programming pulses move every *healthy*
    element to its target state, while stuck elements keep their stuck value.
    Idempotent — re-applying the same mask is a no-op."""
    cells = np.asarray(cells)
    if mask.shape != cells.shape:
        raise ValueError(
            f"mask shape {mask.shape} != cells shape {cells.shape}"
        )
    r1_lrs = np.isin(cells, (CELL_1, CELL_MM))
    r2_lrs = np.isin(cells, (CELL_0, CELL_MM))
    r1_lrs = (r1_lrs & ~mask.sa0_r1) | mask.sa1_r1
    r2_lrs = (r2_lrs & ~mask.sa0_r2) | mask.sa1_r2
    return _PAIR_TO_CELL[r1_lrs.astype(int), r2_lrs.astype(int)]


def _require_rng(rng: Optional[np.random.Generator],
                 fn_name: str) -> np.random.Generator:
    if rng is not None:
        return rng
    # The old silent default_rng(0) fallback made every fault sweep draw the
    # same chip; the one-release deprecation shim has expired.
    raise TypeError(
        f"{fn_name}() requires an explicit rng=np.random.default_rng(seed) "
        "argument (the silent default_rng(0) fallback was removed)"
    )


def apply_saf(
    cells: np.ndarray,
    p_sa0: float,
    p_sa1: float,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Inject stuck-at faults into a cell-state array (any shape).

    One-shot convenience: ``apply_saf_mask(cells, sample_saf(...))``.  Keep
    the ``SAFMask`` instead when the chip needs to be written again later
    (spare-row repair).

    .. versionchanged:: 0.8
       ``rng`` is required whenever faults are actually drawn; the silent
       ``default_rng(0)`` fallback was removed.
    """
    cells = np.asarray(cells)
    if p_sa0 == 0.0 and p_sa1 == 0.0:
        return cells.copy()
    rng = _require_rng(rng, "apply_saf")
    return apply_saf_mask(cells, sample_saf(cells.shape, p_sa0, p_sa1, rng))


def pin_stuck(cells: torch.Tensor, mask: SAFMask) -> torch.Tensor:
    """``apply_saf_mask`` as tensor ops on ``cells``' device: project an
    int8 cell grid through a chip's stuck elements.  ``mask``'s four grids
    may be numpy arrays or tensors (a device copy is kept by the caller
    that pins the same chip repeatedly)."""
    if tuple(mask.shape) != tuple(cells.shape):
        raise ValueError(
            f"mask shape {tuple(mask.shape)} != cells shape "
            f"{tuple(cells.shape)}"
        )
    dev = cells.device

    def grid(a) -> torch.Tensor:
        return torch.as_tensor(a, device=dev)

    r1_lrs = (cells == CELL_1) | (cells == CELL_MM)
    r2_lrs = (cells == CELL_0) | (cells == CELL_MM)
    r1_lrs = (r1_lrs & ~grid(mask.sa0_r1)) | grid(mask.sa1_r1)
    r2_lrs = (r2_lrs & ~grid(mask.sa0_r2)) | grid(mask.sa1_r2)
    return _pair_to_cell(r1_lrs, r2_lrs)


# ---------------------------------------------------------------------------
# Temporal degradation: conductance drift / retention / read disturb
# ---------------------------------------------------------------------------

def _per_row(x, n_rows: int) -> np.ndarray:
    """Broadcast a scalar or (rows,) vector to a (rows, 1) column for
    element-grid arithmetic."""
    a = np.asarray(x, dtype=np.float64)
    if a.ndim == 0:
        return np.full((n_rows, 1), float(a))
    if a.shape != (n_rows,):
        raise ValueError(
            f"per-row quantity has shape {a.shape}, expected ({n_rows},) "
            "or a scalar"
        )
    return a[:, None]


def _pair_to_cell(r1_lrs: torch.Tensor, r2_lrs: torch.Tensor
                  ) -> torch.Tensor:
    """``_PAIR_TO_CELL`` lookup of two boolean element grids -> int8 cells."""
    table = torch.from_numpy(_PAIR_TO_CELL.ravel()).to(r1_lrs.device)
    idx = r1_lrs.to(torch.int64) * 2
    idx += r2_lrs
    return table[idx]


def _scalar(v: float, dev: torch.device) -> torch.Tensor:
    """A float64 0-d tensor on ``dev``.  Dividing by it (or into it) is an
    IEEE division on every device: CUDA turns ``tensor / python_float``
    into a multiplication by the reciprocal, which can differ in the last
    bit from numpy's quotient."""
    return torch.tensor(v, dtype=torch.float64, device=dev)


@dataclasses.dataclass(frozen=True)
class DriftModel:
    """Persistent per-element drift state of one physical chip.

    Two float64 exponent grids of the cell-grid shape (one per resistive
    element) on the device, sampled once per chip with ``sample_drift`` —
    the chip's fast-drifting elements stay its fast-drifting elements across
    rewrites; only the *stress clock* resets when a row is (re)programmed.

    ``t_since_write`` / ``reads_since_write`` arguments are per-row (the
    write/refresh granularity) — scalars or (rows,) vectors, host values.
    Cell grids may be numpy arrays or int8 tensors; results are tensors on
    the model's device (``*_ref``: the copied numpy bodies, numpy results).
    """

    spec: DriftSpec
    nu_r1: torch.Tensor
    nu_r2: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.nu_r1.shape)

    @property
    def device(self) -> torch.device:
        return self.nu_r1.device

    def _stress_np(self, t_since_write, reads_since_write,
                   n_rows: Optional[int] = None) -> np.ndarray:
        rows = self.shape[0] if n_rows is None else n_rows
        t = _per_row(t_since_write, rows)
        k = _per_row(reads_since_write, rows)
        return np.maximum(t + self.spec.read_disturb_s * k, 0.0)

    def stress_time(self, t_since_write, reads_since_write,
                    n_rows: Optional[int] = None) -> torch.Tensor:
        """(rows, 1) equivalent stress time on the device: wall age +
        read-disturb contribution (each read adds ``read_disturb_s`` stress
        seconds).  Per-row host arithmetic, as in the JAX package."""
        return torch.from_numpy(
            self._stress_np(t_since_write, reads_since_write, n_rows)
        ).to(self.device)

    def growth(self, t_since_write, reads_since_write
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-element resistance walk factors (>= 1), one grid per element:
        ``(1 + t_eff/t0)^ν * exp(t_eff/τ_ret)``.  The per-row columns
        ``1 + t_eff/t0`` and ``exp(t_eff/τ_ret)`` are host arithmetic, as in
        the JAX package; the per-element power runs on the device."""
        t_eff = self._stress_np(t_since_write, reads_since_write)
        base = torch.from_numpy(1.0 + t_eff / self.spec.t0).to(self.device)
        ret = (torch.from_numpy(np.exp(t_eff / self.spec.retention_tau_s)).to(
            self.device) if math.isfinite(self.spec.retention_tau_s) else None)
        out = []
        for nu in (self.nu_r1, self.nu_r2):
            f = torch.pow(base, nu)
            if ret is not None:
                f.mul_(ret)
            out.append(f)
        return out[0], out[1]

    def _cells(self, cells) -> torch.Tensor:
        c = torch.as_tensor(cells, device=self.device)
        if tuple(c.shape) != self.shape:
            raise ValueError(
                f"cells shape {tuple(c.shape)} != drift grid {self.shape}"
            )
        return c

    def resistances(
        self, cells, t_since_write, reads_since_write, hw=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Effective per-element resistances (R1, R2) of the programmed
        grid after drift: LRS elements drift up by f, HRS elements down by
        ``f ** hrs_drift_scale``."""
        hw = hw or _default_hw()
        c = self._cells(cells)
        f1, f2 = self.growth(t_since_write, reads_since_write)
        g = self.spec.hrs_drift_scale
        r_hrs = _scalar(hw.r_hrs, self.device)
        out = []
        for f, lrs_states in ((f1, (CELL_1, CELL_MM)),
                              (f2, (CELL_0, CELL_MM))):
            lrs = (c == lrs_states[0]) | (c == lrs_states[1])
            hrs_r = torch.div(r_hrs, f ** g)
            out.append(torch.where(lrs, f.mul_(hw.r_lrs), hrs_r))
            del f, hrs_r, lrs
        del f1, f2
        return out[0], out[1]

    def readout(
        self, cells, t_since_write, reads_since_write, hw=None,
    ) -> torch.Tensor:
        """Discrete int8 cell states the sense path effectively sees, on the
        device: an element whose drifted resistance crossed the LRS/HRS
        midpoint ``sqrt(r_lrs * r_hrs)`` reads as the *other* state
        (retention failure).  At t_eff = 0 this is the identity."""
        hw = hw or _default_hw()
        r1, r2 = self.resistances(cells, t_since_write, reads_since_write, hw)
        mid = math.sqrt(hw.r_lrs * hw.r_hrs)
        a = r1 < mid
        del r1
        b = r2 < mid
        del r2
        return _pair_to_cell(a, b)

    def cell_resistances(
        self, cells, t_since_write, reads_since_write, hw=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-cell effective resistance in the match and mismatch search
        states — the input to ``core.energy.sensing_margins``.

        On a match the searched branch runs through the cell's HRS-state
        element (the ON transistor in series with it, the other branch
        through the OFF transistor); on a mismatch through its LRS-state
        element.  CELL_X / CELL_MM cells use the stored element roles
        unchanged (both elements share a state, so the branch choice only
        picks which drift sample applies)."""
        hw = hw or _default_hw()
        c = self._cells(cells)
        r1, r2 = self.resistances(c, t_since_write, reads_since_write, hw)
        r1_lrs = (c == CELL_1) | (c == CELL_MM)
        hrs_elem = torch.where(r1_lrs, r2, r1)   # HRS-state element
        lrs_elem = torch.where(r1_lrs, r1, r2)   # LRS-state element
        del r1, r2, r1_lrs
        r_match = _par_np(hrs_elem + hw.r_on, lrs_elem + hw.r_off)
        r_mismatch = _par_np(lrs_elem + hw.r_on, hrs_elem + hw.r_off)
        return r_match, r_mismatch

    def flip_threshold(self, hw=None) -> float:
        """Walk factor at which an LRS element reads as HRS (and, scaled by
        1/hrs_drift_scale, vice versa): ``sqrt(r_hrs / r_lrs)``."""
        hw = hw or _default_hw()
        return math.sqrt(hw.r_hrs / hw.r_lrs)

    # -- plain versions: the JAX package's numpy bodies -----------------------
    def growth_ref(self, t_since_write, reads_since_write
                   ) -> tuple[np.ndarray, np.ndarray]:
        """``growth`` as the copied numpy body (host arrays)."""
        t_eff = self._stress_np(t_since_write, reads_since_write)
        base = 1.0 + t_eff / self.spec.t0
        ret = (np.exp(t_eff / self.spec.retention_tau_s)
               if math.isfinite(self.spec.retention_tau_s) else 1.0)
        nu_r1, nu_r2 = (n.cpu().numpy() for n in (self.nu_r1, self.nu_r2))
        return base ** nu_r1 * ret, base ** nu_r2 * ret

    def _resistances_ref(self, cells, t_since_write, reads_since_write, hw):
        cells = np.asarray(cells)
        if cells.shape != self.shape:
            raise ValueError(
                f"cells shape {cells.shape} != drift grid {self.shape}"
            )
        f1, f2 = self.growth_ref(t_since_write, reads_since_write)
        r1_lrs = np.isin(cells, (CELL_1, CELL_MM))
        r2_lrs = np.isin(cells, (CELL_0, CELL_MM))
        g = self.spec.hrs_drift_scale
        r1 = np.where(r1_lrs, hw.r_lrs * f1, hw.r_hrs / f1 ** g)
        r2 = np.where(r2_lrs, hw.r_lrs * f2, hw.r_hrs / f2 ** g)
        return r1, r2

    def readout_ref(self, cells: np.ndarray, t_since_write,
                    reads_since_write, hw=None) -> np.ndarray:
        """``readout`` as the copied numpy body (int8 host grid)."""
        hw = hw or _default_hw()
        r1, r2 = self._resistances_ref(cells, t_since_write,
                                       reads_since_write, hw)
        mid = math.sqrt(hw.r_lrs * hw.r_hrs)
        return _PAIR_TO_CELL[(r1 < mid).astype(int), (r2 < mid).astype(int)]

    def cell_resistances_ref(self, cells: np.ndarray, t_since_write,
                             reads_since_write, hw=None
                             ) -> tuple[np.ndarray, np.ndarray]:
        """``cell_resistances`` as the copied numpy body (host grids)."""
        hw = hw or _default_hw()
        cells = np.asarray(cells)
        r1, r2 = self._resistances_ref(cells, t_since_write,
                                       reads_since_write, hw)
        r1_lrs = np.isin(cells, (CELL_1, CELL_MM))
        hrs_elem = np.where(r1_lrs, r2, r1)
        lrs_elem = np.where(r1_lrs, r1, r2)
        r_match = _par_np(hrs_elem + hw.r_on, lrs_elem + hw.r_off)
        r_mismatch = _par_np(lrs_elem + hw.r_on, hrs_elem + hw.r_off)
        return r_match, r_mismatch


def _par_np(a, b):
    """Parallel resistance of two grids (numpy arrays or tensors)."""
    return a * b / (a + b)


def _default_hw():
    from .energy import DEFAULT_HW

    return DEFAULT_HW


def sample_drift(
    shape: tuple[int, ...],
    spec: DriftSpec,
    rng: Optional[np.random.Generator] = None,
    *,
    device: DeviceLike = None,
) -> DriftModel:
    """Sample one chip's persistent per-element drift exponents:
    ``ν_elem = |N(nu, nu_sigma)|`` per resistive element (rng required
    whenever nu_sigma > 0 — the fleet must not silently share one chip).

    The draws are the JAX package's (numpy, ``nu_r1`` then ``nu_r2``); both
    grids then move to ``device`` once, as float64, and stay there."""
    dev = resolve_device(device)
    if spec.nu_sigma > 0:
        rng = _require_rng(rng, "sample_drift")
        # nu_r1, then nu_r2, each on the device before the next draw
        grids = [torch.from_numpy(
            np.abs(rng.normal(spec.nu, spec.nu_sigma, shape))).to(dev)
            for _ in range(2)]
    else:
        grids = [torch.full(tuple(shape), float(spec.nu), dtype=torch.float64,
                            device=dev) for _ in range(2)]
    return DriftModel(spec=spec, nu_r1=grids[0], nu_r2=grids[1])


def noisy_inputs(
    X: np.ndarray,
    sigma_in: float,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Add input-encoding noise to (normalized) features (paper: σ_in sweep).

    .. versionchanged:: 0.8
       ``rng`` is required whenever noise is actually drawn; the silent
       ``default_rng(0)`` fallback was removed.
    """
    if sigma_in <= 0:
        return np.asarray(X, dtype=np.float64)
    rng = _require_rng(rng, "noisy_inputs")
    X = np.asarray(X, dtype=np.float64)
    return X + rng.normal(0.0, sigma_in, size=X.shape)
