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

Temporal mechanisms (conductance drift, retention decay, read disturb) are
described by ``DriftSpec``; sampling and serving them belongs to the
degradation slice of the port and is not carried here yet.

Stuck faults are *physical, persistent* chip properties: the same elements
stay stuck (``SAFMask``) no matter what is later written.  ``apply_saf``
remains the one-shot convenience wrapper (sample + apply).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .lut import CELL_0, CELL_1, CELL_MM, CELL_X

__all__ = [
    "NonIdealSpec", "IDEAL", "SAFMask", "sample_saf", "apply_saf_mask",
    "apply_saf", "noisy_inputs", "CELL_TO_PAIR", "DriftSpec",
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
    per chip: ``|N(nu, nu_sigma)|`` — the chip's weakest
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
