"""The port's model lifecycle against the JAX package's, case for case with
``test_lifecycle.py``: registry blobs and index written by either package
load in the other with equal version ids; delta / full / forest write plans,
their figures, the wear ledger and the wear-leveling remapper give equal
outputs; and the server's shadow stage / mirror / promote / rollback and the
``LifecycleManager`` give equal ``PromotionReport``s, metrics and
predictions to the JAX server with the same rng.

Tolerance: exact.  Arrays are compared with ``np.array_equal``, reports and
snapshots with ``==`` (NaN equal to NaN), float64 figures to the last bit.
"""
import dataclasses

import numpy as np
import pytest

import repro
import repro.lifecycle as jlc
import repro.reliability as jrel
import repro.serve as jserve
from repro.core import DT2CAM as JaxDT2CAM
from repro.core import HardwareParams as JaxHW
from repro.core import NonIdealSpec as JaxSpec
from repro.dt import load_split
from repro_torch.core import (CELL_1, CELL_X, DT2CAM, FeatureMismatch,
                              HardwareParams, NonIdealSpec, apply_saf_mask,
                              compile_tree, encode_inputs, sample_saf,
                              simulate, train_tree, write_energy)
from repro_torch.forest import (compile_forest, forest_infer_ref,
                                train_forest)
from repro_torch.lifecycle import (LifecycleManager, ModelRegistry,
                                   WearTracker, content_hash, plan_delta,
                                   plan_forest_delta, plan_full,
                                   wear_level_rows)
from repro_torch.lifecycle.delta import _pad_grid
from repro_torch.reliability import repair_layout, run_bist
from repro_torch.serve import ServeConfig, TCAMServer

REQUEST_FIELDS = ("prediction", "survivor", "n_survivors", "active_evals",
                  "energy_j", "bucket", "engine")
PLAN_ARRAYS = ("rows", "cols", "old", "new", "set_map", "reset_map",
               "class_rows")


@pytest.fixture(scope="module")
def retrained_pair():
    """v1 on clean iris, v2 retrained on noise-perturbed features; each in
    both packages."""
    Xtr, ytr, Xte, yte = load_split("iris")
    rng = np.random.default_rng(7)
    Xtr2 = Xtr + rng.normal(0, 1, Xtr.shape) * 0.1 * Xtr.std(0, keepdims=True)
    t1 = DT2CAM(s=16, max_depth=5).fit(Xtr, ytr)
    t2 = DT2CAM(s=16, max_depth=5).fit(Xtr2, ytr)
    j1 = JaxDT2CAM(s=16, max_depth=5).fit(Xtr, ytr)
    j2 = JaxDT2CAM(s=16, max_depth=5).fit(Xtr2, ytr)
    return (t1, t2), (j1, j2), (Xtr, ytr, Xte, yte)


def _sync_cfg(module=None, **kw):
    base = dict(background=False, engine="ref", max_batch=16, min_bucket=8)
    base.update(kw)
    return (module or ServeConfig)(**base)


def _pair(tm, jm, engine="ref", nonideal=None, seed=None, **cfg):
    """A port server and a JAX server on the same model, config and rng."""
    kt, kj = {}, {}
    if nonideal is not None:
        kt["nonideal"], kj["nonideal"] = (NonIdealSpec(**nonideal),
                                          JaxSpec(**nonideal))
    if seed is not None:
        kt["rng"] = np.random.default_rng(seed)
        kj["rng"] = np.random.default_rng(seed)
    t = TCAMServer(tm.compiled, config=_sync_cfg(engine=engine, **cfg),
                   device="cpu", **kt)
    j = jserve.TCAMServer(jm.compiled,
                          config=_sync_cfg(jserve.ServeConfig, engine=engine,
                                           **cfg), **kj)
    return t, j


def _assert_served_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in REQUEST_FIELDS:
            assert getattr(g, f) == getattr(w, f), f


def _assert_reports_equal(got, want):
    a, b = got.summary(), want.summary()
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k]), k
        else:
            assert a[k] == b[k], k


def _assert_plans_equal(got, want):
    assert got.kind == want.kind and got.shape == want.shape
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for f in ("n_cells_written", "class_set", "class_reset"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.summary() == want.summary()
    assert got.figures() == want.figures()


def _both(f, *args, **kw):
    """Call the port's and the JAX package's function of the same name."""
    return f(*args, **kw), getattr(jlc, f.__name__)(*args, **kw)


# --------------------------------------------------------------------------
# registry: content addressing, round-trip, lineage, cross-package blobs
# --------------------------------------------------------------------------
def test_registry_tree_round_trip_and_idempotence(retrained_pair, tmp_path):
    (t1, t2), (j1, j2), (Xtr, ytr, Xte, _) = retrained_pair
    reg = ModelRegistry(tmp_path / "reg")
    jreg = jlc.ModelRegistry(tmp_path / "jreg")
    r1 = reg.publish(t1.compiled, "iris", metadata={"gen": 1})
    r2 = reg.publish(t2.compiled, "iris", parents=[r1.version_id])
    jr1 = jreg.publish(j1.compiled, "iris", metadata={"gen": 1})
    jr2 = jreg.publish(j2.compiled, "iris", parents=[jr1.version_id])
    # version ids and content hashes equal the JAX package's
    assert (r1.version_id, r2.version_id) == (jr1.version_id, jr2.version_id)
    assert r1.content_hash == content_hash(t1.compiled) == jr1.content_hash
    assert len(reg) == 2 and r1.version_id in reg

    again = reg.publish(t1.compiled, "iris")
    assert again.version_id == r1.version_id and len(reg) == 2

    loaded = reg.load(r1.version_id)
    c = t1.compiled
    np.testing.assert_array_equal(loaded.layout.cells, c.layout.cells)
    np.testing.assert_array_equal(loaded.layout.class_bits,
                                  c.layout.class_bits)
    np.testing.assert_array_equal(loaded.tree.feature, c.tree.feature)
    np.testing.assert_array_equal(loaded.table.th1, c.table.th1)
    assert len(loaded.lut.thresholds) == len(c.lut.thresholds)
    for a, b in zip(loaded.lut.thresholds, c.lut.thresholds):
        np.testing.assert_array_equal(a, b)
    assert content_hash(loaded) == r1.content_hash
    xb = encode_inputs(loaded.lut, Xte)
    np.testing.assert_array_equal(
        simulate(loaded.layout, xb).predictions,
        simulate(c.layout, encode_inputs(c.lut, Xte)).predictions,
    )

    # each package reads the other's registry directory
    for reader, root in ((ModelRegistry, "jreg"), (jlc.ModelRegistry, "reg")):
        other = reader(tmp_path / root)
        assert len(other) == 2
        assert other.latest("iris").version_id == r2.version_id
        lineage = other.lineage(r2.version_id)
        assert [v.version_id for v in lineage] == [r2.version_id,
                                                   r1.version_id]
        back = other.load(r1.version_id)
        np.testing.assert_array_equal(back.layout.cells, c.layout.cells)
        assert content_hash(back) == r1.content_hash
        assert jlc.content_hash(back) == r1.content_hash


def test_registry_forest_round_trip(tmp_path):
    Xtr, ytr, Xte, _ = load_split("iris")
    forest = compile_forest(train_forest(Xtr, ytr, n_trees=3, max_depth=4,
                                         seed=0), s=16)
    jforest = repro.compile_forest(
        repro.train_forest(Xtr, ytr, n_trees=3, max_depth=4, seed=0), s=16)
    reg = ModelRegistry(tmp_path / "reg")
    rv = reg.publish(forest, "grove")
    jrv = jlc.ModelRegistry(tmp_path / "jreg").publish(jforest, "grove")
    assert rv.kind == "forest" and rv.n_banks == 3
    assert rv.version_id == jrv.version_id
    assert rv.lut_shape == jrv.lut_shape and rv.metadata == jrv.metadata

    for loaded in (reg.load(rv.version_id),
                   ModelRegistry(tmp_path / "jreg").load(rv.version_id),
                   jlc.ModelRegistry(tmp_path / "reg").load(rv.version_id)):
        assert loaded.n_banks == 3 and loaded.vote == forest.vote
        for lb, fb in zip(loaded.banks, forest.banks):
            np.testing.assert_array_equal(lb.layout.cells, fb.layout.cells)
            assert (lb.proba is None) == (fb.proba is None)
        np.testing.assert_array_equal(
            repro.forest_infer_ref(loaded, Xte).predictions,
            forest_infer_ref(forest, Xte).predictions,
        )
        assert content_hash(loaded) == rv.content_hash


def test_registry_rejects_bad_names_and_unknown_refs(retrained_pair,
                                                     tmp_path):
    (t1, _), _, _ = retrained_pair
    reg = ModelRegistry(tmp_path / "reg")
    with pytest.raises(ValueError, match="may not contain"):
        reg.publish(t1.compiled, "bad:name")
    with pytest.raises(KeyError, match="parent"):
        reg.publish(t1.compiled, "m", parents=["m:doesnotexist"])
    with pytest.raises(KeyError, match="unknown version"):
        reg.load("m:doesnotexist")
    with pytest.raises(KeyError, match="no versions"):
        reg.latest("m")


# --------------------------------------------------------------------------
# delta planner: pulse maps, apply-verification, delta < full
# --------------------------------------------------------------------------
def test_plan_delta_reproduces_target_and_beats_full(retrained_pair):
    (t1, t2), _, _ = retrained_pair
    o, n = t1.compiled.layout, t2.compiled.layout
    kw = dict(old_class_bits=o.class_bits, new_class_bits=n.class_bits)
    d, jd = _both(plan_delta, o.cells, n.cells, **kw)
    f, jf = _both(plan_full, o.cells, n.cells, **kw)
    _assert_plans_equal(d, jd)
    _assert_plans_equal(f, jf)
    assert 0 < d.n_cells_written < f.n_cells_written
    assert f.n_cells_written == f.shape[0] * f.shape[1]
    np.testing.assert_array_equal(d.apply(o.cells), jd.apply(o.cells))
    np.testing.assert_array_equal(d.apply(o.cells),
                                  _pad_grid(n.cells, d.shape))
    np.testing.assert_array_equal(f.apply(o.cells),
                                  _pad_grid(n.cells, f.shape))
    pulses = d.set_map + d.reset_map
    assert (pulses[d.rows, d.cols] >= 1).all()
    assert int((pulses > 0).sum()) == d.n_cells_changed
    assert d.n_pulses < f.n_pulses


def test_plan_delta_identical_grids_is_empty():
    cells = np.full((4, 8), CELL_X, np.int8)
    cells[:, 0] = CELL_1
    d, jd = _both(plan_delta, cells, cells)
    _assert_plans_equal(d, jd)
    assert d.n_cells_written == 0 and d.n_pulses == 0
    assert d.rows_touched == 0
    np.testing.assert_array_equal(d.apply(cells), cells)


def test_plan_delta_aligns_mismatched_shapes():
    small = np.full((2, 4), CELL_1, np.int8)
    big = np.full((4, 6), CELL_X, np.int8)
    d, jd = _both(plan_delta, small, big)
    _assert_plans_equal(d, jd)
    assert d.shape == (4, 6)
    assert d.n_cells_written == 8 and d.n_set == 0 and d.n_reset == 8


def test_write_energy_and_figures_model():
    kw = dict(e_set=2e-12, e_reset=3e-12, t_prog=5e-9, endurance_writes=100.0)
    hw, jhw = HardwareParams(**kw), JaxHW(**kw)
    assert write_energy(10, 4, hw) == repro.core.write_energy(10, 4, jhw)
    assert write_energy(10, 4, hw) == pytest.approx(10 * 2e-12 + 4 * 3e-12)
    cells = np.full((2, 4), CELL_X, np.int8)
    target = cells.copy()
    target[0, 1] = CELL_1
    target[1, 2] = CELL_1
    d, jd = _both(plan_delta, cells, target)
    figs = d.figures(hw)
    assert figs == jd.figures(jhw)
    assert figs["set_pulses"] == 2 and figs["reset_pulses"] == 0
    assert figs["energy_j"] == pytest.approx(2 * 2e-12)
    assert figs["time_s"] == pytest.approx(2 * 5e-9)
    assert figs["endurance_cycles_consumed"] == 2


def test_plan_forest_delta_handles_added_and_retired_banks():
    Xtr, ytr, _, _ = load_split("iris")
    trees = train_forest(Xtr, ytr, n_trees=3, max_depth=4, seed=1)
    f2, f3 = (compile_forest(trees[:2], s=16), compile_forest(trees, s=16))
    for old, new, full in ((f2, f3, False), (f3, f2, False), (f2, f3, True)):
        plans, jplans = _both(plan_forest_delta, old, new, full=full)
        assert len(plans) == len(jplans) == 3
        for p, jp in zip(plans, jplans):
            _assert_plans_equal(p, jp)
    plans = plan_forest_delta(f2, f3)
    assert plans[2].n_reset == 0 and plans[2].n_set > 0
    back = plan_forest_delta(f3, f2)
    assert back[2].n_set == 0 and back[2].n_reset > 0
    assert all(p.kind == "full" for p in plan_forest_delta(f2, f3, full=True))


# --------------------------------------------------------------------------
# wear: endurance ledger + wear-leveling row placement
# --------------------------------------------------------------------------
def test_wear_tracker_accumulates_and_flags_worn_cells():
    w = WearTracker(hw=HardwareParams(endurance_writes=3.0))
    jw = jlc.WearTracker(hw=JaxHW(endurance_writes=3.0))
    a = np.full((2, 4), CELL_X, np.int8)
    b = a.copy()
    b[0, 1] = CELL_1
    there, back = plan_delta(a, b), plan_delta(b, a)
    for _ in range(2):
        for tracker in (w, jw):
            tracker.record(there)
            tracker.record(back)
    assert w.snapshot() == jw.snapshot()
    np.testing.assert_array_equal(w.counts, jw.counts)
    assert w.plans_recorded == 4
    assert w.total_pulses == 4 and w.max_cell_pulses == 4
    assert w.headroom() == jw.headroom() and w.headroom() < 0
    assert w.worn_out()[0, 1] and w.worn_out().sum() == 1
    np.testing.assert_array_equal(w.worn_rows(), [0])
    np.testing.assert_array_equal(w.row_wear(), jw.row_wear())
    snap = w.snapshot()
    assert snap["worn_cells"] == 1 and snap["endurance_writes"] == 3.0
    grow = plan_delta(np.full((5, 9), CELL_X, np.int8),
                      np.full((5, 9), CELL_1, np.int8))
    w.record(grow)
    jw.record(grow)
    assert w.counts.shape == (5, 9)
    np.testing.assert_array_equal(w.counts, jw.counts)


def _assert_remaps_equal(got, want):
    for f in ("cells", "classes", "class_bits"):
        np.testing.assert_array_equal(getattr(got.layout, f),
                                      getattr(want.layout, f))
    np.testing.assert_array_equal(got.row_map, want.row_map)
    np.testing.assert_array_equal(got.forbidden, want.forbidden)
    assert got.summary() == want.summary()


def test_wear_level_rows_functional_equivalence(retrained_pair):
    (t1, t2), _, (Xtr, _, Xte, _) = retrained_pair
    w, jw = WearTracker(), jlc.WearTracker()
    init = plan_full(np.zeros((0, 0), np.int8), t1.compiled.layout.cells)
    w.record(init)
    jw.record(init)
    rm = wear_level_rows(t2.compiled.layout, t1.compiled.layout.cells, w)
    _assert_remaps_equal(rm, jlc.wear_level_rows(
        t2.compiled.layout, t1.compiled.layout.cells, jw))
    xb = encode_inputs(t2.compiled.lut, Xte)
    np.testing.assert_array_equal(
        simulate(rm.layout, xb).predictions,
        simulate(t2.compiled.layout, xb).predictions,
    )
    assert rm.row_map.shape[0] == t2.compiled.layout.n_rows
    assert len(np.unique(rm.row_map)) == rm.row_map.shape[0]


def test_wear_level_rows_respects_forbidden_rows(retrained_pair):
    (t1, t2), _, (Xtr, _, Xte, _) = retrained_pair
    forbidden = [0, 3]
    rm, jrm = _both(wear_level_rows, t2.compiled.layout,
                    t1.compiled.layout.cells, forbidden=forbidden)
    _assert_remaps_equal(rm, jrm)
    assert not set(forbidden) & set(rm.row_map.tolist())
    assert (rm.layout.cells[forbidden, 0] == CELL_1).all()
    xb = encode_inputs(t2.compiled.lut, Xte)
    np.testing.assert_array_equal(
        simulate(rm.layout, xb).predictions,
        simulate(t2.compiled.layout, xb).predictions,
    )
    with pytest.raises(ValueError, match="out of range"):
        wear_level_rows(t2.compiled.layout, t1.compiled.layout.cells,
                        forbidden=[10_000])
    n_phys = t2.compiled.layout.cells.shape[0]
    with pytest.raises(ValueError, match="cannot place"):
        wear_level_rows(t2.compiled.layout, t1.compiled.layout.cells,
                        forbidden=np.arange(n_phys))


def test_wear_level_composes_with_spare_row_repair():
    Xtr, ytr, Xte, _ = load_split("iris")
    c = compile_tree(train_tree(Xtr, ytr, max_depth=5), 16, spare_rows=12)
    lay = c.layout
    mask = sample_saf(lay.cells.shape, 0.03, 0.03, np.random.default_rng(3))
    faulty = dataclasses.replace(lay, cells=apply_saf_mask(lay.cells, mask))
    bist = run_bist(faulty.cells, lay.cells, used=1 + lay.width,
                    n_rows=lay.cells.shape[0], device="cpu")
    _, _, report = repair_layout(faulty, lay.cells, mask, bist.defective_rows)
    _, _, jreport = jrel.repair_layout(faulty, lay.cells, mask,
                                       bist.defective_rows)
    blocked = report.blocked_rows
    np.testing.assert_array_equal(blocked, jreport.blocked_rows)
    assert blocked.size > 0
    rm, jrm = _both(wear_level_rows, lay, lay.cells, forbidden=blocked)
    _assert_remaps_equal(rm, jrm)
    assert not set(blocked.tolist()) & set(rm.row_map.tolist())


# --------------------------------------------------------------------------
# serving: shadow slot, promotion gates, atomic swap, rollback
# --------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["ref", "mxu"])
def test_stage_mirror_promote_and_bit_exactness(retrained_pair, engine):
    (t1, t2), (j1, j2), (Xtr, _, Xte, _) = retrained_pair
    srv, jsrv = _pair(t1, j1, engine)
    srv.stage(t2.compiled, mirror_fraction=1.0)
    jsrv.stage(j2.compiled, mirror_fraction=1.0)
    assert srv.staged and srv.health()["candidate_staged"]

    n = len(Xte[:16])
    for s in (srv, jsrv):
        s.submit_many(Xte[:n])
        s.pump(force=True)
    lc = srv.metrics()["lifecycle"]
    assert lc == jsrv.metrics()["lifecycle"]
    assert lc["stages"] == 1
    assert lc["shadow_batches"] == 1 and lc["shadow_requests"] == n

    rep = srv.promote(min_shadow_batches=1, max_disagreement=1.0)
    _assert_reports_equal(rep, jsrv.promote(min_shadow_batches=1,
                                            max_disagreement=1.0))
    assert rep.promoted and rep.reason == "promoted" and not srv.staged
    assert rep.canary_accuracy >= srv._config.canary_threshold
    assert srv.metrics()["lifecycle"] == jsrv.metrics()["lifecycle"]
    assert srv.metrics()["lifecycle"]["promotions"] == 1

    res = srv.serve(Xte)
    _assert_served_equal(res, jsrv.serve(Xte))
    ref = simulate(t2.compiled.layout,
                   encode_inputs(t2.compiled.lut, Xte)).predictions
    np.testing.assert_array_equal([r.prediction for r in res], ref)
    srv.close(), jsrv.close()


def test_mirror_fraction_is_deterministic(retrained_pair):
    (t1, t2), (j1, j2), (_, _, Xte, _) = retrained_pair
    srv, jsrv = _pair(t1, j1, max_batch=8)
    srv.stage(t2.compiled, mirror_fraction=0.25)
    jsrv.stage(j2.compiled, mirror_fraction=0.25)
    for _ in range(8):
        for s in (srv, jsrv):
            s.submit_many(Xte[:8])
            s.pump(force=True)
    lc = srv.metrics()["lifecycle"]
    assert lc == jsrv.metrics()["lifecycle"]
    assert lc["shadow_batches"] == 2
    assert lc["shadow_requests"] == 16
    srv.close(), jsrv.close()


def test_promote_gate_insufficient_shadow_keeps_candidate(retrained_pair):
    (t1, t2), (j1, j2), _ = retrained_pair
    srv, jsrv = _pair(t1, j1)
    srv.stage(t2.compiled, mirror_fraction=1.0)
    jsrv.stage(j2.compiled, mirror_fraction=1.0)
    rep = srv.promote(min_shadow_batches=3)
    _assert_reports_equal(rep, jsrv.promote(min_shadow_batches=3))
    assert not rep.promoted and rep.reason == "insufficient_shadow"
    assert rep.staged and srv.staged
    assert srv.metrics()["lifecycle"]["promotion_failures"] == 0
    srv.close(), jsrv.close()


def test_promote_gate_disagreement_unstages(retrained_pair):
    (t1, t2), (j1, j2), (Xtr, _, Xte, _) = retrained_pair
    p1 = simulate(t1.compiled.layout,
                  encode_inputs(t1.compiled.lut, Xte)).predictions
    p2 = simulate(t2.compiled.layout,
                  encode_inputs(t2.compiled.lut, Xte)).predictions
    drift = np.flatnonzero(p1 != p2)
    assert drift.size > 0, "fixture models must disagree somewhere"

    srv, jsrv = _pair(t1, j1)
    srv.stage(t2.compiled, mirror_fraction=1.0)
    jsrv.stage(j2.compiled, mirror_fraction=1.0)
    for s in (srv, jsrv):
        s.submit_many(np.tile(Xte[drift], (2, 1))[:8])
        s.pump(force=True)
    rep = srv.promote(max_disagreement=0.0)
    _assert_reports_equal(rep, jsrv.promote(max_disagreement=0.0))
    assert not rep.promoted and rep.reason == "disagreement"
    assert rep.disagreement_rate > 0.0
    assert not rep.staged and not srv.staged
    lc = srv.metrics()["lifecycle"]
    assert lc == jsrv.metrics()["lifecycle"]
    assert lc["promotion_failures"] == 1 and lc["promotions"] == 0
    res = srv.serve(Xte[:8])
    _assert_served_equal(res, jsrv.serve(Xte[:8]))
    np.testing.assert_array_equal([r.prediction for r in res], p1[:8])
    srv.close(), jsrv.close()


@pytest.mark.parametrize("engine", ["ref", "mxu"])
def test_promote_gate_candidate_canary_failure(retrained_pair, engine):
    (t1, t2), (j1, j2), (_, _, Xte, _) = retrained_pair
    srv, jsrv = _pair(t1, j1, engine, nonideal=dict(p_sa0=0.10, p_sa1=0.10),
                      seed=11, canary_threshold=0.99)
    srv.stage(t2.compiled, mirror_fraction=1.0)
    jsrv.stage(j2.compiled, mirror_fraction=1.0)
    for s in (srv, jsrv):
        s.submit_many(Xte[:16])
        s.pump(force=True)
    rep = srv.promote(min_shadow_batches=1, max_disagreement=1.0)
    _assert_reports_equal(rep, jsrv.promote(min_shadow_batches=1,
                                            max_disagreement=1.0))
    assert not rep.promoted and rep.reason == "canary"
    assert rep.canary_accuracy < 0.99
    assert not srv.staged
    assert srv.metrics()["lifecycle"] == jsrv.metrics()["lifecycle"]
    assert srv.metrics()["lifecycle"]["promotion_failures"] == 1
    srv.close(), jsrv.close()


@pytest.mark.parametrize("engine", ["ref", "mxu"])
def test_rollback_unstages_then_reverts(retrained_pair, engine):
    (t1, t2), (j1, j2), (_, _, Xte, _) = retrained_pair
    srv, jsrv = _pair(t1, j1, engine)
    with pytest.raises(RuntimeError, match="nothing to roll back"):
        srv.rollback()

    srv.stage(t2.compiled, mirror_fraction=1.0)
    jsrv.stage(j2.compiled, mirror_fraction=1.0)
    assert srv.rollback() == jsrv.rollback() == "unstaged"
    assert not srv.staged

    srv.stage(t2.compiled, mirror_fraction=1.0)
    jsrv.stage(j2.compiled, mirror_fraction=1.0)
    for s in (srv, jsrv):
        s.submit_many(Xte[:16])
        s.pump(force=True)
    assert srv.promote(max_disagreement=1.0).promoted
    assert jsrv.promote(max_disagreement=1.0).promoted
    assert srv.rollback() == jsrv.rollback() == "reverted"
    res = srv.serve(Xte)
    _assert_served_equal(res, jsrv.serve(Xte))
    ref = simulate(t1.compiled.layout,
                   encode_inputs(t1.compiled.lut, Xte)).predictions
    np.testing.assert_array_equal([r.prediction for r in res], ref)
    assert srv.metrics()["lifecycle"] == jsrv.metrics()["lifecycle"]
    assert srv.metrics()["lifecycle"]["rollbacks"] == 2
    srv.close(), jsrv.close()


def test_stage_validation_errors(retrained_pair):
    (t1, t2), _, (Xtr, ytr, Xte, _) = retrained_pair
    srv = TCAMServer(t1.compiled, config=_sync_cfg(), device="cpu")
    with pytest.raises(ValueError, match="mirror_fraction"):
        srv.stage(t2.compiled, mirror_fraction=0.0)
    wrong = DT2CAM(s=16, max_depth=3).fit(Xtr[:, :2], ytr)
    with pytest.raises(FeatureMismatch, match="candidate expects"):
        srv.stage(wrong.compiled)
    srv.stage(t2.compiled)
    with pytest.raises(RuntimeError, match="already staged"):
        srv.stage(t2.compiled)
    srv.close()

    forest = compile_forest(train_forest(Xtr, ytr, n_trees=2, max_depth=3,
                                         seed=0), s=16)
    fsrv = TCAMServer(forest, config=_sync_cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="single-model only"):
        fsrv.stage(t2.compiled)
    with pytest.raises(RuntimeError, match="single-model only"):
        _ = fsrv.live_intent
    fsrv.close()


def test_stage_reuses_persistent_saf_mask(retrained_pair):
    (t1, t2), (j1, j2), (_, _, Xte, _) = retrained_pair
    srv, jsrv = _pair(t1, j1, nonideal=dict(p_sa0=0.02, p_sa1=0.02), seed=2)
    assert t1.compiled.layout.cells.shape == t2.compiled.layout.cells.shape
    srv.stage(t2.compiled)
    jsrv.stage(j2.compiled)
    assert srv._candidate.saf_mask is srv._saf_mask
    np.testing.assert_array_equal(srv._candidate.layout.cells,
                                  jsrv._candidate.layout.cells)
    # the candidate's device operands are its own
    assert srv._candidate.operands is not srv._operands
    srv.close(), jsrv.close()


# --------------------------------------------------------------------------
# manager: registry -> plan -> shadow -> promote, with the wear ledger
# --------------------------------------------------------------------------
def _managers(retrained_pair, tmp_path, wear_level=False):
    (t1, t2), (j1, j2), (_, _, Xte, _) = retrained_pair
    reg = ModelRegistry(tmp_path / "reg")
    jreg = jlc.ModelRegistry(tmp_path / "jreg")
    r1 = reg.publish(t1.compiled, "iris")
    r2 = reg.publish(t2.compiled, "iris", parents=[r1.version_id])
    jr1 = jreg.publish(j1.compiled, "iris")
    jreg.publish(j2.compiled, "iris", parents=[jr1.version_id])
    srv, jsrv = _pair(t1, j1)
    mgr = LifecycleManager(reg, srv, live_version=r1.version_id)
    jmgr = jlc.LifecycleManager(jreg, jsrv, live_version=r1.version_id)
    plan = mgr.stage(r2.version_id, mirror_fraction=1.0,
                     wear_level=wear_level)
    _assert_plans_equal(plan, jmgr.stage(r2.version_id, mirror_fraction=1.0,
                                         wear_level=wear_level))
    for s in (srv, jsrv):
        s.submit_many(Xte[:16])
        s.pump(force=True)
    return (mgr, jmgr), (srv, jsrv), (r1, r2), plan


def test_manager_full_cycle(retrained_pair, tmp_path):
    (mgr, jmgr), (srv, jsrv), (r1, r2), plan = _managers(retrained_pair,
                                                         tmp_path)
    assert plan.kind == "delta" and srv.staged
    assert mgr.candidate_version == r2.version_id
    assert mgr.wear.plans_recorded == 2

    rep = mgr.promote(min_shadow_batches=1, max_disagreement=1.0)
    _assert_reports_equal(rep, jmgr.promote(min_shadow_batches=1,
                                            max_disagreement=1.0))
    assert rep.promoted
    assert mgr.live_version == r2.version_id
    assert mgr.candidate_version is None

    st = mgr.status()
    assert st == jmgr.status()
    assert st["live_version"] == r2.version_id and not st["staged"]
    assert st["plans_executed"] == 2
    assert st["last_plan_figures"]["energy_j"] > 0
    assert st["wear"]["total_pulses"] > 0
    np.testing.assert_array_equal(mgr.wear.counts, jmgr.wear.counts)

    assert mgr.rollback() == jmgr.rollback() == "reverted"
    assert mgr.live_version == r1.version_id
    srv.close(), jsrv.close()


def test_manager_wear_leveled_stage_stays_functional(retrained_pair,
                                                     tmp_path):
    (t1, t2), _, (_, _, Xte, _) = retrained_pair
    (mgr, jmgr), (srv, jsrv), _, _ = _managers(retrained_pair, tmp_path,
                                               wear_level=True)
    assert mgr.promote(max_disagreement=1.0).promoted
    assert jmgr.promote(max_disagreement=1.0).promoted
    res = srv.serve(Xte)
    _assert_served_equal(res, jsrv.serve(Xte))
    ref = simulate(t2.compiled.layout,
                   encode_inputs(t2.compiled.lut, Xte)).predictions
    np.testing.assert_array_equal([r.prediction for r in res], ref)
    srv.close(), jsrv.close()


def test_manager_requires_attachment(tmp_path, retrained_pair):
    (t1, _), _, _ = retrained_pair
    reg = ModelRegistry(tmp_path / "reg")
    reg.publish(t1.compiled, "iris")
    mgr = LifecycleManager(reg)
    with pytest.raises(RuntimeError, match="no server attached"):
        mgr.stage("anything")
    with pytest.raises(ValueError, match="requires a server"):
        mgr.attach(None, "anything")


# --------------------------------------------------------------------------
# hot swap under live background load: zero dropped, zero errors
# --------------------------------------------------------------------------
def test_background_hot_swap_drops_nothing(retrained_pair):
    (t1, t2), _, (_, _, Xte, _) = retrained_pair
    cfg = ServeConfig(engine="ref", max_batch=16, max_delay_s=0.001,
                      background=True)
    srv = TCAMServer(t1.compiled, config=cfg, device="cpu")
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(Xte), size=300)

    futs = []
    for i, x in enumerate(Xte[idx]):
        futs.append(srv.submit(x))
        if i == 100:
            srv.stage(t2.compiled, mirror_fraction=0.5)
        elif i == 200:
            srv.drain(timeout=60.0)
            rep = srv.promote(min_shadow_batches=1, max_disagreement=1.0)
            assert rep.promoted, rep.reason
    srv.drain(timeout=60.0)

    assert all(f.done() for f in futs), "dropped requests across the swap"
    assert all(f.exception() is None for f in futs), "errored requests"
    p1 = simulate(t1.compiled.layout,
                  encode_inputs(t1.compiled.lut, Xte[idx])).predictions
    p2 = simulate(t2.compiled.layout,
                  encode_inputs(t2.compiled.lut, Xte[idx])).predictions
    served = np.array([f.result().prediction for f in futs])
    assert ((served == p1) | (served == p2)).all()
    lc = srv.metrics()["lifecycle"]
    assert lc["promotions"] == 1 and lc["shadow_batches"] >= 1
    srv.close()
