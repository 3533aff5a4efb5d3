"""The port's temporal degradation against the JAX package's, case for case
with ``test_degradation.py``: the drift model (its tensor readout against the
copied numpy body and the JAX one), the sensing margins, refresh plans and
the scrub scheduler, and the torch server's virtual drift clock, margin- and
period-driven scrubs, and the breaker's scrub rung, each with the same
inputs and the same rng on both sides; then the server under drift with
stuck faults, SA offsets and input noise (the draw order), repair and
promotion under drift, all against the JAX server.

Tolerances, fixed before the comparison:

- cell grids (readouts, served layouts), row selections (``due``,
  ``rows_refreshed``, ``rows_skipped``), write plans, wear ledgers, server
  predictions and every scrub count or energy: exact;
- the walk factors and the per-cell resistances: ``rtol=1e-14`` (float64
  ``pow`` in PyTorch and in numpy may differ by an ulp or two);
- the margins (``SenseMargins`` fields, their summaries, ``margin_min_v``):
  ``rtol=1e-12, atol=1e-15``.  The tensor version sums each division's
  conductances in another order than numpy's loop, and its ``exp`` may
  differ by an ulp.

The port's server runs on 'ref', as the JAX tests run theirs, and on the
port's default CPU engine ('auto'); the JAX server runs on 'ref'."""
import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core import DT2CAM as JaxDT2CAM
from repro.core import NonIdealSpec as JaxSpec
from repro.core import energy as jenergy
from repro.core.nonideal import DriftSpec as JaxDriftSpec
from repro.core.nonideal import sample_drift as jax_sample_drift
from repro.degradation import ScrubPolicy as JaxScrubPolicy
from repro.degradation import ScrubScheduler as JaxScrubScheduler
from repro.degradation import layout_margins as jax_layout_margins
from repro.degradation import plan_refresh as jax_plan_refresh
from repro.dt import load_split
from repro.lifecycle.wear import WearTracker as JaxWearTracker
from repro_torch.core import (CELL_0, CELL_1, CELL_MM, CELL_X, DT2CAM,
                              NonIdealSpec)
from repro_torch.core.energy import (DEFAULT_HW, mismatch_probability,
                                     mismatch_probability_ref,
                                     sensing_margins, sensing_margins_ref)
from repro_torch.core.nonideal import DriftSpec, sample_drift
from repro_torch.degradation import (ScrubPolicy, ScrubScheduler,
                                     layout_margins, layout_margins_ref,
                                     plan_refresh)
from repro_torch.lifecycle.wear import WearTracker
from repro_torch.serve import ServeConfig, TCAMServer

DRIFT_KW = dict(nu=0.05, nu_sigma=0.02, retention_tau_s=2e6)
DRIFT = DriftSpec(**DRIFT_KW)
JAX_DRIFT = JaxDriftSpec(**DRIFT_KW)
CPU = torch.device("cpu")
GROWTH_RTOL = 1e-14
MARGIN_TOL = dict(rtol=1e-12, atol=1e-15)
MARGIN_KEYS = ("min_v", "mean_v", "margin_min_v")
REQUEST_FIELDS = ("prediction", "survivor", "n_survivors", "active_evals",
                  "energy_j", "bucket")
PORT_ENGINES = ["ref", "auto"]


@pytest.fixture(scope="module")
def iris_models():
    Xtr, ytr, Xte, yte = load_split("iris")
    tm = DT2CAM(s=16, max_depth=5).fit(Xtr, ytr)
    jm = JaxDT2CAM(s=16, max_depth=5).fit(Xtr, ytr)
    np.testing.assert_array_equal(tm.compiled.layout.cells,
                                  jm.compiled.layout.cells)
    return tm, jm, Xte, yte


@pytest.fixture(scope="module")
def iris_spares():
    Xtr, ytr, Xte, yte = load_split("iris")
    tm = DT2CAM(s=16, max_depth=5, spare_rows=24).fit(Xtr, ytr)
    jm = JaxDT2CAM(s=16, max_depth=5, spare_rows=24).fit(Xtr, ytr)
    np.testing.assert_array_equal(tm.compiled.layout.cells,
                                  jm.compiled.layout.cells)
    return tm, jm, Xtr, ytr, Xte, yte


def _grid():
    """A small grid exercising all four cell states."""
    return np.array([[CELL_0, CELL_1, CELL_X],
                     [CELL_1, CELL_MM, CELL_0],
                     [CELL_X, CELL_0, CELL_1]], np.int8)


def _models(shape, spec, jspec, seed=0):
    """The port's drift model (on the CPU) and the JAX one, same draws."""
    rng = None if seed is None else np.random.default_rng(seed)
    jrng = None if seed is None else np.random.default_rng(seed)
    tmod = sample_drift(shape, spec, rng, device="cpu")
    jmod = jax_sample_drift(shape, jspec, jrng)
    np.testing.assert_array_equal(tmod.nu_r1.numpy(), jmod.nu_r1)
    np.testing.assert_array_equal(tmod.nu_r2.numpy(), jmod.nu_r2)
    return tmod, jmod


def _assert_readout(tmod, jmod, cells, t, k):
    """Tensor readout == copied numpy body == JAX readout, exactly."""
    got = tmod.readout(cells, t, k)
    assert got.dtype == torch.int8 and got.device == CPU
    want = jmod.readout(cells, t, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmod.readout_ref(cells, t, k), want)
    return want


def _assert_margins(got, want):
    for f in ("margin_match", "margin_mismatch"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   **MARGIN_TOL)
    np.testing.assert_array_equal(got.v_ref, want.v_ref)
    np.testing.assert_allclose(got.margin, want.margin, **MARGIN_TOL)
    _assert_same(got.summary(), want.summary())


def _assert_same(a, b, key=None):
    """Nested dicts / lists / arrays equal, NaN equal to NaN; floats under a
    margin key within the margin tolerance, every other value exact."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            _assert_same(a[k], b[k], k)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y, key)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and isinstance(b, float):
        if math.isnan(a):
            assert math.isnan(b), key
        elif key in MARGIN_KEYS:
            assert math.isclose(a, b, rel_tol=MARGIN_TOL["rtol"],
                                abs_tol=MARGIN_TOL["atol"]), (key, a, b)
        else:
            assert a == b, (key, a, b)
    else:
        assert a == b, (key, a, b)


def _assert_report(got, want):
    np.testing.assert_array_equal(got.rows_refreshed, want.rows_refreshed)
    np.testing.assert_array_equal(got.rows_skipped, want.rows_skipped)
    assert got.figures == want.figures
    _assert_same(got.summary(), want.summary())


def _assert_plan(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


# --------------------------------------------------------------------------
# drift model
# --------------------------------------------------------------------------
def test_drift_spec_validation_and_ideality():
    assert DriftSpec().is_ideal
    assert not DRIFT.is_ideal
    assert DriftSpec(read_disturb_s=1.0).is_ideal   # no law to accumulate
    for bad in (dict(nu=-0.1), dict(nu_sigma=-1.0), dict(t0=0.0),
                dict(retention_tau_s=0.0), dict(read_disturb_s=-1.0),
                dict(hrs_drift_scale=-0.5)):
        with pytest.raises(ValueError):
            DriftSpec(**bad)
        with pytest.raises(ValueError):
            JaxDriftSpec(**bad)
    for kw in (dict(), dict(drift=DriftSpec()), dict(drift=DRIFT)):
        spec = NonIdealSpec(**kw)
        jkw = {k: JaxDriftSpec(**dataclasses.asdict(v)) for k, v in kw.items()}
        jspec = JaxSpec(**jkw)
        assert (spec.has_drift, spec.is_ideal) == (jspec.has_drift,
                                                   jspec.is_ideal)
    assert NonIdealSpec(drift=DRIFT).has_drift
    assert not NonIdealSpec(drift=DRIFT).is_ideal
    with pytest.raises(TypeError):
        NonIdealSpec(drift=0.1)


def test_drift_zero_stress_is_identity():
    cells = _grid()
    tmod, jmod = _models(cells.shape, DRIFT, JAX_DRIFT)
    f1, f2 = tmod.growth(0.0, 0)
    assert f1.dtype == torch.float64 and f1.device == CPU
    assert torch.all(f1 == 1.0) and torch.all(f2 == 1.0)
    out = _assert_readout(tmod, jmod, cells, 0.0, 0)
    np.testing.assert_array_equal(out, cells)


def test_drift_growth_monotone_and_retention_flips_to_dont_care():
    cells = _grid()
    spec = DriftSpec(nu=0.0, retention_tau_s=2e6)      # pure retention decay
    tmod, jmod = _models(cells.shape, spec,
                         JaxDriftSpec(nu=0.0, retention_tau_s=2e6), seed=None)
    f_a, _ = tmod.growth(1e5, 0)
    f_b, _ = tmod.growth(1e6, 0)
    assert torch.all(f_b > f_a) and torch.all(f_a > 1.0)
    for t in (1e5, 1e6):
        for got, want, ref in zip(tmod.growth(t, 0), jmod.growth(t, 0),
                                  tmod.growth_ref(t, 0)):
            np.testing.assert_allclose(got.numpy(), want, rtol=GROWTH_RTOL)
            np.testing.assert_array_equal(ref, want)
    # past the LRS flip threshold (but short of the attenuated HRS flip) a
    # determinate cell's LRS element reads HRS -> the cell reads as CELL_X
    assert tmod.flip_threshold() == jmod.flip_threshold()
    t = 2e6 * math.log(2 * tmod.flip_threshold())
    out = _assert_readout(tmod, jmod, cells, t, 0)
    det = np.isin(cells, (CELL_0, CELL_1))
    assert (out[det] == CELL_X).all()
    assert (out[cells == CELL_X] == CELL_X).all()


def test_drift_read_disturb_adds_stress():
    spec = DriftSpec(nu=0.1, read_disturb_s=0.5)
    tmod, jmod = _models((2, 3), spec,
                         JaxDriftSpec(nu=0.1, read_disturb_s=0.5), seed=None)
    assert torch.allclose(tmod.stress_time(0.0, 100),
                          torch.tensor(50.0, dtype=torch.float64))
    got = tmod.stress_time(10.0, [100, 0])
    np.testing.assert_array_equal(got.numpy(), np.array([[60.0], [10.0]]))
    np.testing.assert_array_equal(got.numpy(), jmod.stress_time(10.0, [100, 0]))
    f_idle, _ = tmod.growth(10.0, 0)
    f_read, _ = tmod.growth(10.0, 100)
    assert torch.all(f_read > f_idle)
    with pytest.raises(ValueError, match="per-row"):
        tmod.stress_time([1.0, 2.0, 3.0], 0)


def test_sample_drift_seeded_and_rng_required():
    a, _ = _models((4, 4), DRIFT, JAX_DRIFT, seed=7)
    b = sample_drift((4, 4), DRIFT, np.random.default_rng(7), device="cpu")
    assert torch.equal(a.nu_r1, b.nu_r1) and torch.equal(a.nu_r2, b.nu_r2)
    assert a.nu_r1.dtype == torch.float64 and bool((a.nu_r1 >= 0).all())
    with pytest.raises(TypeError, match="rng"):
        sample_drift((4, 4), DRIFT, device="cpu")       # nu_sigma > 0
    c, _ = _models((4, 4), DriftSpec(nu=0.05), JaxDriftSpec(nu=0.05),
                   seed=None)                           # deterministic law
    assert bool((c.nu_r1 == 0.05).all())


@pytest.mark.parametrize("t,reads", [(0.0, 0), (1e3, 7), (1e5, 0),
                                     (1e6, 300), (3e7, 0)])
def test_readout_equals_plain_and_jax_on_layouts(iris_models, t, reads):
    """Tensor readout, copied body and JAX readout on the 3x3 grid and on
    the iris layout, at per-row ages and read counts drawn from a seed."""
    tm, _, _, _ = iris_models
    spec = DriftSpec(nu=0.05, nu_sigma=0.02, retention_tau_s=2e6,
                     read_disturb_s=10.0)
    jspec = JaxDriftSpec(**dataclasses.asdict(spec))
    lay = tm.compiled.layout
    for cells in (_grid(), lay.cells):
        tmod, jmod = _models(cells.shape, spec, jspec, seed=3)
        rng = np.random.default_rng(int(t) + reads)
        ages = rng.uniform(0.0, t, cells.shape[0])
        k = rng.integers(0, reads + 1, cells.shape[0])
        _assert_readout(tmod, jmod, cells, ages, k)
        _assert_readout(tmod, jmod, torch.from_numpy(cells), t, reads)
        for got, want in zip(tmod.cell_resistances(cells, ages, k),
                             jmod.cell_resistances(cells, ages, k)):
            np.testing.assert_allclose(got.numpy(), want, rtol=GROWTH_RTOL)
        for got, want in zip(tmod.cell_resistances_ref(cells, ages, k),
                             jmod.cell_resistances(cells, ages, k)):
            np.testing.assert_array_equal(got, want)
    if t >= 3e7:
        assert (tmod.readout(lay.cells, t, 0).numpy() != lay.cells).any()


# --------------------------------------------------------------------------
# sensing margins
# --------------------------------------------------------------------------
def test_sensing_margins_ideal_grid_positive():
    hw = DEFAULT_HW
    rows, cols, s = 4, 8, 4
    r_match = torch.full((rows, cols), hw.r_cell_match, dtype=torch.float64)
    r_mismatch = torch.full((rows, cols), hw.r_cell_mismatch,
                            dtype=torch.float64)

    def both(rm, rmm, **kw):
        got = sensing_margins(rm, rmm, s=s, used=cols, hw=hw, **kw)
        np_kw = {k: v.numpy() for k, v in kw.items()}
        want = jenergy.sensing_margins(rm.numpy(), rmm.numpy(), s=s,
                                       used=cols, hw=hw, **np_kw)
        _assert_margins(got, want)
        _assert_margins(sensing_margins_ref(rm.numpy(), rmm.numpy(), s=s,
                                            used=cols, hw=hw, **np_kw), want)
        return got

    sm = both(r_match, r_mismatch)
    assert sm.margin_match.shape == (rows,)
    assert (sm.margin > 0).all()
    # trimmed references sit midway between full-match and 1-mismatch
    assert np.allclose(sm.margin_match, sm.margin_mismatch)
    assert sm.summary()["rows_negative"] == 0
    # HRS drifting down leaks the matching line -> match margin erodes;
    # LRS drifting up weakens the mismatch discharge -> mismatch margin erodes
    leaky = both(r_match / 3.0, r_mismatch)
    assert (leaky.margin_match < sm.margin_match).all()
    weak = both(r_match, r_mismatch * 3.0)
    assert (weak.margin_mismatch < sm.margin_mismatch).all()
    # masked columns, a ragged last division, rows with no determinate cell
    rng = np.random.default_rng(0)
    rm = torch.from_numpy(rng.uniform(1e5, 3e5, (5, 11)))
    rmm = torch.from_numpy(rng.uniform(1e4, 3e4, (5, 11)))
    det = torch.from_numpy(rng.random((5, 11)) < 0.5)
    det[2] = False
    for used in (1, 4, 9, 11, 20):
        got = sensing_margins(rm, rmm, s=s, used=used, hw=hw,
                              determinate=det)
        want = jenergy.sensing_margins(rm.numpy(), rmm.numpy(), s=s,
                                       used=used, hw=hw,
                                       determinate=det.numpy())
        _assert_margins(got, want)
    with pytest.raises(ValueError):
        sensing_margins(r_match, r_mismatch[:, :4], s=s, used=cols)


def test_mismatch_probability_limits():
    m = torch.tensor([-0.2, 0.0, 0.2], dtype=torch.float64)
    assert mismatch_probability(m, 0.0).tolist() == [1.0, 0.5, 0.0]
    p = mismatch_probability(m, 0.05)
    assert p[0] > 0.99 and p[2] < 0.01
    assert float(p[1]) == pytest.approx(0.5)
    assert torch.allclose(p + mismatch_probability(-m, 0.05),
                          torch.ones(3, dtype=torch.float64))
    grid = np.linspace(-0.5, 0.5, 101)
    for sigma in (0.0, 0.01, 0.05, 0.3):
        want = jenergy.mismatch_probability(grid, sigma)
        np.testing.assert_array_equal(mismatch_probability_ref(grid, sigma),
                                      want)
        np.testing.assert_allclose(
            mismatch_probability(grid, sigma, device="cpu").numpy(), want,
            rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError):
        mismatch_probability(m, -1.0)


# --------------------------------------------------------------------------
# refresh plans + scheduler
# --------------------------------------------------------------------------
def test_plan_refresh_pulse_accounting_and_identity():
    cells = _grid()
    plan = plan_refresh(cells, [0, 2], used=3)
    _assert_plan(plan, jax_plan_refresh(cells, [0, 2], used=3))
    assert plan.kind == "refresh"
    assert plan.n_set + plan.n_reset == 2 * 2 * 3
    assert plan.n_pulses == plan.n_set + plan.n_reset
    assert (plan.old == plan.new).all()
    assert (plan.apply(cells) == plan.apply(plan.apply(cells))).all()
    figs = plan.figures(DEFAULT_HW)
    assert figs == jax_plan_refresh(cells, [0, 2], used=3).figures(DEFAULT_HW)
    assert figs["energy_j"] > 0 and figs["pulses"] == plan.n_pulses
    assert plan.rows_touched == 2
    assert sorted(np.unique(plan.rows).tolist()) == [0, 2]
    with pytest.raises(ValueError):
        plan_refresh(cells, [5])


def test_scrub_scheduler_margin_policy_selection():
    scheds = []
    for Sched, Pol, Wear in ((ScrubScheduler, ScrubPolicy, WearTracker),
                             (JaxScrubScheduler, JaxScrubPolicy,
                              JaxWearTracker)):
        wear = Wear((6, 3))
        scheds.append((Sched(6, policy=Pol(kind="margin", margin_v=0.15,
                                           max_rows=2), wear=wear), wear))
    margins = np.array([0.5, 0.10, 0.05, 0.2, -0.1, 0.12])
    cells = np.full((6, 3), CELL_1, np.int8)
    out = []
    for sch, wear in scheds:
        assert sch.due(margins, blocked=()).tolist() == [4, 2]
        assert sch.due(margins, blocked=[2]).tolist() == [4, 1]
        sch.advance(100.0)
        plan, report = sch.scrub(cells, margins, used=3, blocked=[2])
        assert report.rows_due == 4
        assert report.rows_refreshed.tolist() == [4, 1]
        assert set(report.rows_skipped.tolist()) == {2, 5}
        assert report.margin_min_v == pytest.approx(-0.1)
        ages = sch.ages()
        assert ages[4] == ages[1] == 0.0 and ages[0] == 100.0
        assert wear.total_pulses == plan.n_pulses == report.figures["pulses"]
        snap = sch.snapshot()
        assert snap["scrub_passes"] == 1 and snap["rows_refreshed_total"] == 2
        out.append((plan, report, snap, wear.snapshot()))
    (tp, tr, ts, tw), (jp, jr, js, jw) = out
    _assert_plan(tp, jp)
    _assert_report(tr, jr)
    assert ts == js and tw == jw


def test_scrub_scheduler_periodic_policy_and_forced():
    out = []
    for Sched, Pol in ((ScrubScheduler, ScrubPolicy),
                       (JaxScrubScheduler, JaxScrubPolicy)):
        sch = Sched(4, policy=Pol(kind="periodic", period_s=100))
        sch.advance(100.0)
        sch.note_write([0])
        sch.advance(50.0)
        assert sch.due().tolist() == [1, 2, 3]
        cells = np.full((4, 2), CELL_0, np.int8)
        _, report = sch.scrub(cells, force_rows=[0, 1], used=2)
        assert report.policy == "forced"
        assert report.rows_refreshed.tolist() == [0, 1]
        sch.note_reads(5)
        sch.note_reads(3, rows=[2])
        assert sch.reads.tolist() == [5, 5, 8, 5]
        assert sch.snapshot()["max_reads"] == 8
        out.append((report, sch.snapshot(), sch.ages()))
    (tr, ts, ta), (jr, js, ja) = out
    _assert_report(tr, jr)
    assert ts == js
    np.testing.assert_array_equal(ta, ja)


def test_scrub_scheduler_validation():
    for bad in (dict(kind="eager"), dict(period_s=0.0), dict(max_rows=0)):
        with pytest.raises(ValueError):
            ScrubPolicy(**bad)
        with pytest.raises(ValueError):
            JaxScrubPolicy(**bad)
    with pytest.raises(ValueError):
        ScrubScheduler(0)
    sch = ScrubScheduler(3)
    with pytest.raises(ValueError):
        sch.advance(-1.0)
    with pytest.raises(ValueError):
        sch.due()                                     # margin policy, no margins
    with pytest.raises(ValueError):
        sch.due(np.zeros(2))                          # wrong margins shape


def test_layout_margins_monotone_in_drift(iris_models):
    tm, jm, _, _ = iris_models
    lay = tm.compiled.layout
    tmod, jmod = _models(lay.cells.shape, DRIFT, JAX_DRIFT)
    mins = []
    for t in (0.0, 1e5, 1e6, 1e7):
        got = layout_margins(lay, tmod, t, 0)
        want = jax_layout_margins(jm.compiled.layout, jmod, t, 0)
        _assert_margins(got, want)
        _assert_margins(layout_margins_ref(lay, tmod, t, 0), want)
        # margin_v=1.0 flags every row: the worst-first order then shows
        # that rows tied in the JAX package (equal rows at t=0) stay tied
        for margin_v in (0.15, 1.0):
            due = ScrubScheduler(lay.cells.shape[0], policy=ScrubPolicy(
                kind="margin", margin_v=margin_v)).due(got.margin)
            jdue = JaxScrubScheduler(lay.cells.shape[0], policy=JaxScrubPolicy(
                kind="margin", margin_v=margin_v)).due(want.margin)
            np.testing.assert_array_equal(due, jdue)
        mins.append(float(got.margin.min()))
    assert mins == sorted(mins, reverse=True)         # margins only erode
    assert mins[0] > 0 > mins[-1]                     # fresh ok, aged broken


# --------------------------------------------------------------------------
# serving integration, against the JAX server with the same rng
# --------------------------------------------------------------------------
def _pair(tm, jm, engine, nonideal=None, seed=0, wear=False, **cfg_kw):
    """A port server on the CPU and a JAX server, same chip, same rng."""
    nonideal = dict(drift=True) if nonideal is None else nonideal
    kw = dict(background=False, max_batch=16)
    kw.update(cfg_kw)

    def spec(Spec, Drift):
        d = {k: v for k, v in nonideal.items() if k != "drift"}
        if nonideal.get("drift"):
            d["drift"] = Drift(**DRIFT_KW)
        return Spec(**d)

    srv = TCAMServer(tm.compiled, nonideal=spec(NonIdealSpec, DriftSpec),
                     config=ServeConfig(engine=engine, **kw),
                     rng=np.random.default_rng(seed), device="cpu",
                     wear=(WearTracker(tm.compiled.layout.cells.shape)
                           if wear else None))
    jsrv = jserve.TCAMServer(
        jm.compiled, nonideal=spec(JaxSpec, JaxDriftSpec),
        config=jserve.ServeConfig(engine="ref", **kw),
        rng=np.random.default_rng(seed),
        wear=(JaxWearTracker(jm.compiled.layout.cells.shape)
              if wear else None))
    return srv, jsrv


def _serve_both(srv, jsrv, X):
    got, want = srv.serve(X), jsrv.serve(X)
    for f in REQUEST_FIELDS:
        assert [getattr(r, f) for r in got] == [getattr(r, f) for r in want], f
    np.testing.assert_array_equal(srv.live_layout.cells,
                                  jsrv.live_layout.cells)
    return np.array([r.prediction for r in got])


def _assert_state(srv, jsrv):
    """Served grid, margins, degradation health and metrics equal."""
    np.testing.assert_array_equal(srv.live_layout.cells,
                                  jsrv.live_layout.cells)
    _assert_margins(srv.margins(), jsrv.margins())
    th, jh = srv.health(), jsrv.health()
    _assert_same(th["degradation"], jh["degradation"])
    _assert_same({k: v for k, v in th.items() if k not in ("engine",
                                                           "breaker")},
                 {k: v for k, v in jh.items() if k not in ("engine",
                                                           "breaker")})
    _assert_same(srv.metrics()["degradation"], jsrv.metrics()["degradation"])


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_server_drift_collapse_and_scrub_restores(iris_models, engine):
    tm, jm, Xte, yte = iris_models
    srv, jsrv = _pair(tm, jm, engine)
    assert srv.drift_enabled and jsrv.drift_enabled
    fresh = float((_serve_both(srv, jsrv, Xte) == yte).mean())
    _assert_state(srv, jsrv)
    assert srv.advance_time(3e7) == jsrv.advance_time(3e7)
    aged = float((_serve_both(srv, jsrv, Xte) == yte).mean())
    assert aged < fresh - 0.2
    assert srv.margins().summary()["rows_negative"] > 0
    _assert_state(srv, jsrv)
    report = srv.scrub_now()
    _assert_report(report, jsrv.scrub_now())
    assert report.n_refreshed > 0
    assert float((_serve_both(srv, jsrv, Xte) == yte).mean()) == \
        pytest.approx(fresh)
    deg = srv.metrics()["degradation"]
    assert deg["scrub_passes"] == 1 and deg["rows_scrubbed"] > 0
    assert deg["scrub_energy_j"] > 0
    health = srv.health()["degradation"]
    assert health["wear"]["total_pulses"] == deg["scrub_pulses"] > 0
    assert health["margins"]["rows_negative"] == 0    # post-scrub
    _assert_state(srv, jsrv)
    srv.close()
    jsrv.close()


def test_server_without_drift_rejects_maintenance(iris_models):
    tm, jm, _, _ = iris_models
    srv = TCAMServer(tm.compiled, config=ServeConfig(background=False),
                     device="cpu")
    jsrv = jserve.TCAMServer(jm.compiled,
                             config=jserve.ServeConfig(background=False))
    for s in (srv, jsrv):
        assert not s.drift_enabled
        assert s.health()["degradation"] is None
        for call in (lambda: s.advance_time(1.0), s.margins, s.scrub_now):
            with pytest.raises(RuntimeError, match="NonIdealSpec"):
                call()
        s.close()
    with pytest.raises(ValueError, match="scrub_policy"):
        TCAMServer(tm.compiled, nonideal=NonIdealSpec(drift=DRIFT),
                   config=ServeConfig(background=False, scrub_policy="eager"),
                   device="cpu")


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_server_batch_driven_maintenance(iris_models, engine):
    tm, jm, Xte, _ = iris_models
    srv, jsrv = _pair(tm, jm, engine, scrub_every_batches=1,
                      scrub_policy="periodic", scrub_period_s=1.5e6,
                      time_per_batch_s=1e6)
    for _ in range(4):                                # 4 batches = 4e6 virtual s
        _serve_both(srv, jsrv, Xte[:8])
    deg = srv.metrics()["degradation"]
    assert deg["scrub_passes"] >= 1 and deg["rows_scrubbed"] > 0
    snap = srv.health()["degradation"]
    assert snap["now_s"] == pytest.approx(4e6)
    assert snap["max_age_s"] < 4e6                    # refreshes happened
    _assert_state(srv, jsrv)
    srv.close()
    jsrv.close()


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_breaker_scrub_rung_and_reentry(iris_models, engine):
    """Drifted chip -> canary trip -> scrub rung recovers (REPAIRED, no
    spare-row repair consumed) -> next routine canary re-enters HEALTHY;
    every step as the JAX server's."""
    tm, jm, Xte, _ = iris_models
    srv, jsrv = _pair(tm, jm, engine, canary_every_batches=1, canary_size=32)
    srv.advance_time(3e7)
    jsrv.advance_time(3e7)
    _serve_both(srv, jsrv, Xte[:8])                   # trips + recovers inline
    h = srv.health()
    assert h["breaker"]["recovery"] == "scrub"
    assert h["repair_attempts"] == 0                  # scrub rung was enough
    assert srv.metrics()["degradation"]["scrub_passes"] >= 1
    _assert_same(h["breaker"], jsrv.health()["breaker"])
    _assert_state(srv, jsrv)
    _serve_both(srv, jsrv, Xte[:8])                   # routine canary re-passes
    assert srv.health()["state"] == "healthy"
    _assert_same(srv.health()["breaker"], jsrv.health()["breaker"])
    _assert_same(srv.metrics()["reliability"], jsrv.metrics()["reliability"])
    srv.close()
    jsrv.close()


def test_scrub_never_drops_inflight_requests(iris_models):
    """Chaos-style: a scrub storm concurrent with a live request stream must
    never drop or double-resolve a future."""
    tm, _, Xte, _ = iris_models
    srv = TCAMServer(tm.compiled, nonideal=NonIdealSpec(drift=DRIFT),
                     config=ServeConfig(background=True, max_batch=16,
                                        engine="ref"),
                     rng=np.random.default_rng(0), device="cpu")
    stop = threading.Event()

    def scrubber():
        while not stop.is_set():
            srv.advance_time(5e5)
            srv.scrub_now(force=True)

    th = threading.Thread(target=scrubber, daemon=True)
    th.start()
    try:
        futs = [srv.submit(Xte[i % len(Xte)]) for i in range(64)]
        srv.drain(timeout=60)
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert all(f.done() and f.exception() is None for f in futs)
    assert srv.metrics()["requests_served"] == 64
    assert srv.metrics()["degradation"]["scrub_passes"] > 0
    srv.close()


# --------------------------------------------------------------------------
# the rest of the JAX server's drift behaviour, same rng on both sides
# --------------------------------------------------------------------------
@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_server_drift_with_faults_noise_and_offsets(iris_models, engine):
    """Stuck faults, drift exponents, SA offsets, the canary and σ_in come
    from one rng in the JAX server's order: any other order changes the
    chip, and the served answers with it."""
    tm, jm, Xte, _ = iris_models
    nonideal = dict(drift=True, p_sa0=0.01, p_sa1=0.01, sa_sigma=0.05,
                    sigma_in=0.02)
    srv, jsrv = _pair(tm, jm, engine, nonideal=nonideal, seed=4,
                      scrub_every_batches=2, time_per_batch_s=2e6,
                      canary_every_batches=3)
    np.testing.assert_array_equal(srv._kmax, jsrv._kmax)
    for _ in range(3):
        _serve_both(srv, jsrv, Xte)
        for dt in (1e6, 1e7):
            assert srv.advance_time(dt) == jsrv.advance_time(dt)
            _serve_both(srv, jsrv, Xte[:20])
    _assert_state(srv, jsrv)
    _assert_report(srv.scrub_now(force=True), jsrv.scrub_now(force=True))
    _serve_both(srv, jsrv, Xte)
    _assert_state(srv, jsrv)
    _assert_same(srv.metrics()["reliability"], jsrv.metrics()["reliability"])
    srv.close()
    jsrv.close()


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_server_repair_under_drift(iris_spares, engine):
    """Repair diffs and rewrites the zero-drift base grid, restarts the
    written rows' clocks, and re-derives the served grid; later scrubs skip
    the decoder-disabled rows."""
    tm, jm, _, _, Xte, _ = iris_spares
    srv, jsrv = _pair(tm, jm, engine, seed=2,
                      nonideal=dict(drift=True, p_sa0=0.03, p_sa1=0.03))
    for s in (srv, jsrv):
        s.advance_time(5e5)
    _serve_both(srv, jsrv, Xte)
    got, want = srv.repair(), jsrv.repair()
    assert got.summary() == want.summary() and got.rows_repaired > 0
    assert got.assignments == want.assignments
    np.testing.assert_array_equal(srv._base_layout.cells,
                                  jsrv._base_layout.cells)
    np.testing.assert_array_equal(srv._scrub.ages(), jsrv._scrub.ages())
    _serve_both(srv, jsrv, Xte)
    _assert_state(srv, jsrv)
    for s in (srv, jsrv):
        s.advance_time(3e7)
    _assert_report(srv.scrub_now(), jsrv.scrub_now())
    _serve_both(srv, jsrv, Xte)
    _assert_state(srv, jsrv)
    srv.close()
    jsrv.close()


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_server_promote_under_drift(iris_models, engine):
    """Promotion reprograms the whole array: every clock restarts and the
    served grid is the candidate's fresh one; rollback restores the aged
    model's grids, as in the JAX server.  The candidate is retrained on
    perturbed features to a grid of the same shape (the drift grids are the
    physical array's)."""
    tm, jm, Xte, _ = iris_models
    Xtr, ytr, _, _ = load_split("iris")
    rng = np.random.default_rng(7)
    Xtr2 = Xtr + rng.normal(0, 1, Xtr.shape) * 0.1 * Xtr.std(0, keepdims=True)
    t2 = DT2CAM(s=16, max_depth=5).fit(Xtr2, ytr)
    j2 = JaxDT2CAM(s=16, max_depth=5).fit(Xtr2, ytr)
    assert t2.compiled.layout.cells.shape == tm.compiled.layout.cells.shape
    srv, jsrv = _pair(tm, jm, engine, wear=True)
    for s in (srv, jsrv):
        s.advance_time(3e7)
    _serve_both(srv, jsrv, Xte)
    srv.stage(t2.compiled, mirror_fraction=1.0)
    jsrv.stage(j2.compiled, mirror_fraction=1.0)
    _serve_both(srv, jsrv, Xte[:16])
    got, want = srv.promote(max_disagreement=1.0), jsrv.promote(
        max_disagreement=1.0)
    _assert_same(got.summary(), want.summary())
    assert got.promoted
    assert srv.health()["degradation"]["max_age_s"] == 0.0
    np.testing.assert_array_equal(srv.live_layout.cells,
                                  t2.compiled.layout.cells)
    _serve_both(srv, jsrv, Xte)
    _assert_state(srv, jsrv)
    assert srv.rollback() == jsrv.rollback() == "reverted"
    _serve_both(srv, jsrv, Xte)
    _assert_state(srv, jsrv)
    srv.close()
    jsrv.close()


def test_forest_drift_raises_the_jax_servers_error():
    from repro_torch.forest import compile_forest, train_forest
    Xtr, ytr, _, _ = load_split("iris")
    forest = compile_forest(train_forest(Xtr, ytr, n_trees=2, max_depth=3),
                            s=16)
    with pytest.raises(NotImplementedError,
                       match="drift modelling is single-model only"):
        TCAMServer(forest, nonideal=NonIdealSpec(drift=DRIFT), device="cpu",
                   config=ServeConfig(background=False))
