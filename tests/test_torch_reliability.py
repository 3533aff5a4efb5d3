"""The port's reliability layer against the JAX package's, case for case with
``test_reliability.py``: behavior signatures and march probes, the BIST (the
port's tensor form on ``device="cpu"`` and its plain per-row version),
spare-row repair, ``row_utilization``, redundancy voting, the canary and the
circuit breaker, and the server's self-test / repair / health / breaker
ladder, each with the same inputs and the same rng on both sides; then
forest per-bank repair as ``test_forest.py::test_forest_repair_keeps_serving``.

Tolerance: exact.  Arrays are compared with ``np.array_equal``, report
fields and health dicts with ``==`` (NaN equal to NaN), float64 figures to
the last bit.  The JAX server's 'mxu' engine runs its Pallas kernel in
interpret mode, as the JAX tests run it."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro
import repro.reliability as jrel
import repro.serve as jserve
from repro.core import DT2CAM as JaxDT2CAM
from repro.core import NonIdealSpec as JaxSpec
from repro.dt import load_split
from repro_torch.core import (CELL_0, CELL_1, CELL_MM, CELL_X, DT2CAM,
                              NonIdealSpec, apply_saf_mask, compile_tree,
                              encode_inputs, sample_saf, simulate)
from repro_torch.forest import compile_forest, forest_infer_ref, train_forest
from repro_torch.reliability import (BreakerState, CircuitBreaker,
                                     ReplicatedServer, behavior_changed_rows,
                                     first_survivors, majority_vote,
                                     make_canary, march_probes,
                                     repair_layout, row_match,
                                     row_signatures,
                                     row_utilization, row_utilization_ref,
                                     run_bist, run_bist_ref)
from repro_torch.serve import ServeConfig, TCAMServer

REQUEST_FIELDS = ("prediction", "survivor", "n_survivors", "active_evals",
                  "energy_j", "bucket", "engine")


@pytest.fixture(scope="module")
def iris_models():
    Xtr, ytr, Xte, yte = load_split("iris")
    tm = DT2CAM(s=16, max_depth=5, spare_rows=24).fit(Xtr, ytr)
    jm = JaxDT2CAM(s=16, max_depth=5, spare_rows=24).fit(Xtr, ytr)
    np.testing.assert_array_equal(tm.compiled.layout.cells,
                                  jm.compiled.layout.cells)
    return tm, jm, Xtr, ytr, Xte, yte


def _fault_chip(layout, p, seed):
    mask = sample_saf(layout.cells.shape, p, p, np.random.default_rng(seed))
    cells = apply_saf_mask(layout.cells, mask)
    return dataclasses.replace(layout, cells=cells), mask


def _same(a, b) -> bool:
    """Equality of nested dicts / lists / arrays, NaN equal to NaN."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _assert_bist_equal(got, want):
    np.testing.assert_array_equal(got.detected, want.detected)
    assert got.probes_run == want.probes_run
    assert got.n_rows == want.n_rows
    assert got.summary() == want.summary()


def _bist_all(actual, intent, used, n_rows):
    """Port tensor BIST and plain BIST, each held equal to the JAX one."""
    want = jrel.run_bist(actual, intent, used=used, n_rows=n_rows)
    got = run_bist(actual, intent, used=used, n_rows=n_rows, device="cpu")
    _assert_bist_equal(got, want)
    _assert_bist_equal(run_bist_ref(actual, intent, used=used, n_rows=n_rows),
                       want)
    return got


def _assert_repair_equal(got, want):
    (tl, ti, tr), (jl, ji, jr) = got, want
    for f in ("cells", "classes", "class_bits"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    np.testing.assert_array_equal(ti, ji)
    for f in dataclasses.fields(jr):
        assert getattr(tr, f.name) == getattr(jr, f.name), f.name
    np.testing.assert_array_equal(tr.blocked_rows, jr.blocked_rows)
    assert tr.summary() == jr.summary()


# --------------------------------------------------------------------------
# behavior signatures & march probes (pure logic)
# --------------------------------------------------------------------------
def test_row_signatures_dead_and_literals():
    used = 5
    cells = np.array([
        [CELL_0, CELL_0, CELL_1, CELL_X, CELL_X],    # alive: 0@1, 1@2
        [CELL_1, CELL_X, CELL_X, CELL_X, CELL_X],    # decoder 1 -> dead
        [CELL_0, CELL_X, CELL_MM, CELL_X, CELL_X],   # CELL_MM -> dead
    ], np.int8)
    got = row_signatures(cells, used)
    for g, w in zip(got, jrel.row_signatures(cells, used)):
        np.testing.assert_array_equal(g, w)
    dead, zeros, ones = got
    assert list(dead) == [False, True, True]
    assert list(zeros[0]) == [True, False, False, False]
    assert list(ones[0]) == [False, True, False, False]


def test_behavior_changed_rows_ignores_invisible_faults():
    used = 4
    intent = np.array([[CELL_0, CELL_0, CELL_X, CELL_X]], np.int8)
    same = intent.copy()
    same[0, 0] = CELL_X                       # decoder 0 -> X: invisible
    flipped = intent.copy()
    flipped[0, 1] = CELL_1                    # literal flip: visible
    for actual, changed in ((same, False), (flipped, True)):
        got = behavior_changed_rows(intent, actual, used)
        np.testing.assert_array_equal(
            got, jrel.behavior_changed_rows(intent, actual, used))
        assert got[0] == changed


def test_march_probes_shapes_and_decoder_pinned():
    row = np.array([CELL_0, CELL_1, CELL_0, CELL_X], np.int8)
    probes = march_probes(row, 4)
    np.testing.assert_array_equal(probes, jrel.march_probes(row, 4))
    assert probes.shape == (4, 4)
    assert (probes[:, 0] == 0).all()
    assert list(probes[0]) == [0, 1, 0, 0]
    for i in range(1, 4):
        assert (probes[i] != probes[0]).sum() == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_row_match_equals_jax_on_random_grids(seed):
    """Every cell state, words holding values other than 0 and 1, ``used``
    from 0 to the full width, and widths across the 64-column words."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        r, p = (int(v) for v in rng.integers(1, 30, 2))
        w = int(rng.integers(1, 200))
        used = int(rng.integers(0, w + 1))
        cells = rng.integers(0, 4, (r, w)).astype(np.int8)
        cells[rng.random((r, w)) < 0.6] = CELL_X
        words = rng.integers(0, 2, (p, w)).astype(np.uint8)
        words[rng.random((p, w)) < 0.02] = 2
        np.testing.assert_array_equal(row_match(cells, words, used),
                                      jrel.row_match(cells, words, used))
    np.testing.assert_array_equal(row_match(cells[0], words[0], w),
                                  jrel.row_match(cells[0], words[0], w))


# --------------------------------------------------------------------------
# BIST detection & coverage
# --------------------------------------------------------------------------
def test_bist_clean_chip_reports_nothing(iris_models):
    lay = iris_models[0].compiled.layout
    rep = _bist_all(lay.cells, lay.cells, 1 + lay.width, lay.cells.shape[0])
    assert rep.n_defective == 0
    assert rep.coverage(np.zeros(lay.cells.shape[0], bool)) == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bist_coverage_at_2pct(iris_models, seed):
    lay = iris_models[0].compiled.layout
    used = 1 + lay.width
    flay, _ = _fault_chip(lay, 0.02, seed)
    rep = _bist_all(flay.cells, lay.cells, used, lay.cells.shape[0])
    changed = behavior_changed_rows(lay.cells, flay.cells, used)
    np.testing.assert_array_equal(
        changed, jrel.behavior_changed_rows(lay.cells, flay.cells, used))
    assert rep.coverage(changed) >= 0.90
    assert not (rep.detected & ~changed).any()


def _hand_built(case):
    """Three-row chips the intent family alone cannot judge: (actual, intent,
    used).  ``rogue``: a dead spare whose decoder fault brings it alive
    with three 1-literals; ``mm``: a CELL_MM cell in an alive rule;
    ``decoder``: decoder cells stuck at X (invisible), at 1 and at MM;
    ``readback``: a row whose readback word differs (X -> 1 and 0 -> X)."""
    intent = np.full((3, 8), CELL_X, np.int8)
    intent[:, 0] = CELL_0
    intent[:, 1] = CELL_1
    intent[:, 3] = CELL_0
    actual = intent.copy()
    if case == "rogue":
        intent[0, 0] = CELL_1
        actual = intent.copy()
        actual[0, 0] = CELL_0
        actual[0, 2:5] = CELL_1
    elif case == "mm":
        actual[0, 2] = CELL_MM
        actual[1, 1] = CELL_MM
    elif case == "decoder":
        actual[0, 0] = CELL_X
        actual[1, 0] = CELL_1
        actual[2, 0] = CELL_MM
    elif case == "readback":
        actual[0, 4] = CELL_1
        actual[1, 3] = CELL_X
        actual[2, 1] = CELL_0
    return actual, intent, 6


@pytest.mark.parametrize("case", ["rogue", "mm", "decoder", "readback"])
def test_bist_hand_built_rows_equal_jax(case):
    actual, intent, used = _hand_built(case)
    rep = _bist_all(actual, intent, used, 0)
    changed = behavior_changed_rows(intent, actual, used)
    np.testing.assert_array_equal(rep.detected, changed)
    if case == "rogue":                       # the readback elements catch it
        assert rep.detected[0]
        # row 0 runs both families, the two healthy rows the intent's only
        assert rep.probes_run == 2 * used + used + used


def test_bist_random_grids_equal_jax():
    """Every cell state in every column, readback words that differ and
    ones that do not: the tensor form equals the JAX loop."""
    rng = np.random.default_rng(0)
    for _ in range(40):
        r, w = (int(v) for v in rng.integers(1, 24, 2))
        w += 1
        used = int(rng.integers(1, w + 1))
        intent = rng.integers(0, 4, (r, w)).astype(np.int8)
        actual = intent.copy()
        flip = rng.random((r, w)) < 0.2
        actual[flip] = rng.integers(0, 4, int(flip.sum()))
        _bist_all(actual, intent, used, r)


# --------------------------------------------------------------------------
# spare-row repair
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repair_recovers_accuracy_at_2pct(iris_models, seed):
    tm, jm, Xtr, ytr, Xte, yte = iris_models
    lay, lut = tm.compiled.layout, tm.compiled.lut
    used = 1 + lay.width
    flay, mask = _fault_chip(lay, 0.02, seed)
    rep = _bist_all(flay.cells, lay.cells, used, lay.cells.shape[0])
    xtr = encode_inputs(lut, Xtr)
    prio = row_utilization(lay, xtr, device="cpu")
    np.testing.assert_array_equal(prio, jrel.row_utilization(lay, xtr))
    got = repair_layout(flay, lay.cells, mask, rep.defective_rows,
                        priority=prio)
    _assert_repair_equal(got, jrel.repair_layout(
        flay, lay.cells, mask, rep.defective_rows, priority=prio))
    rlay, rintent, _ = got
    xb = encode_inputs(lut, Xte)
    acc_ideal = (simulate(lay, xb).predictions == yte).mean()
    acc_rep = (simulate(rlay, xb).predictions == yte).mean()
    assert acc_rep >= acc_ideal - 0.01
    expect = apply_saf_mask(rintent, mask)
    expect[:, used:] = CELL_X
    np.testing.assert_array_equal(rlay.cells, expect)
    rep2 = _bist_all(rlay.cells, rintent, used, lay.cells.shape[0])
    assert not behavior_changed_rows(rintent, rlay.cells, used).any()
    assert rep2.n_defective == 0


def test_repair_degrades_gracefully_without_spares(iris_models):
    tm = iris_models[0]
    base = compile_tree(tm.compiled.tree, tm.s, spare_rows=0)
    lay = base.layout
    intent = lay.cells.copy()
    intent[lay.n_rows:, 0] = CELL_0
    lay = dataclasses.replace(lay, cells=intent)
    flay, mask = _fault_chip(lay, 0.05, 0)
    used = 1 + lay.width
    rep = _bist_all(flay.cells, intent, used, lay.cells.shape[0])
    assert any(r < lay.n_rows for r in rep.defective_rows)
    got = repair_layout(flay, intent, mask, rep.defective_rows)
    _assert_repair_equal(got, jrel.repair_layout(flay, intent, mask,
                                                 rep.defective_rows))
    rr = got[2]
    assert rr.unrepaired and rr.degraded
    assert rr.spares_used == 0


def test_repair_priority_orders_heavy_rows(iris_models):
    tm, _, Xtr, *_ = iris_models
    lay, lut = tm.compiled.layout, tm.compiled.lut
    xb = encode_inputs(lut, Xtr)
    util = row_utilization(lay, xb, device="cpu")
    np.testing.assert_array_equal(util, row_utilization_ref(lay, xb))
    np.testing.assert_array_equal(util, jrel.row_utilization(lay, xb))
    assert util.dtype == np.int64
    assert util.shape == (lay.cells.shape[0],)
    assert util.sum() > 0
    assert util[lay.n_rows:].sum() == 0


def test_row_utilization_on_a_faulted_layout_equals_its_plain_version(
        iris_models):
    """Faults in the masked columns are ignored, CELL_MM rows never win."""
    tm, _, Xtr, *_ = iris_models
    lay = tm.compiled.layout
    flay, _ = _fault_chip(lay, 0.05, 4)
    assert (flay.cells == CELL_MM).any()
    assert (flay.cells[:, 1 + lay.width:] != CELL_X).any()
    xb = encode_inputs(tm.compiled.lut, Xtr)
    util = row_utilization(flay, xb, device="cpu")
    np.testing.assert_array_equal(util, row_utilization_ref(flay, xb))
    np.testing.assert_array_equal(util, jrel.row_utilization(flay, xb))


@pytest.mark.parametrize("p", [0.0, 0.05])
def test_first_survivors_equal_jax_row_match(iris_models, p):
    """Each input's first surviving row, -1 where none survives (random
    words mostly match no row), against the JAX package's ``row_match``."""
    tm, _, Xtr, *_ = iris_models
    lay = tm.compiled.layout
    flay, _ = _fault_chip(lay, p, 6)
    rng = np.random.default_rng(6)
    xb = np.concatenate([encode_inputs(tm.compiled.lut, Xtr),
                         rng.integers(0, 2, (64, lay.width), np.uint8)])
    m = jrel.row_match(flay.cells, flay.pad_inputs(xb), 1 + lay.width)
    want = np.where(m.any(axis=0), np.argmax(m, axis=0), -1)
    got = first_survivors(flay, xb, device="cpu")
    assert got.dtype == torch.int64 and (want == -1).any()
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# redundancy voting
# --------------------------------------------------------------------------
def test_majority_vote_plurality_and_ties():
    for votes, win in (([1, 1, 2], 1), ([2, 2, 1, 1, 0], 1), ([3], 3)):
        assert majority_vote(votes) == jrel.majority_vote(votes) == win


_METRIC_KEYS = ("k", "requests", "disagreements", "disagreement_rate",
                "mean_agreement", "replica_failures")


@pytest.mark.parametrize("engine", ["ref", "mxu"])
def test_replicated_server_votes_out_single_chip_errors(iris_models, engine):
    tm, jm, Xtr, ytr, Xte, yte = iris_models
    p = dict(p_sa0=0.02, p_sa1=0.02)
    with ReplicatedServer(
            tm.compiled, k=5, nonideal=NonIdealSpec(**p),
            rng=np.random.default_rng(11), device="cpu",
            config=ServeConfig(engine=engine, background=False,
                               max_batch=32)) as rs, \
            jrel.ReplicatedServer(
                jm.compiled, k=5, nonideal=JaxSpec(**p),
                rng=np.random.default_rng(11),
                config=jserve.ServeConfig(engine=engine, background=False,
                                          max_batch=32)) as js:
        voted, jvoted = rs.serve(Xte), js.serve(Xte)
        met, jmet = rs.metrics(), js.metrics()
        grids = [r._layout.cells.tobytes() for r in rs.replicas]
        assert grids == [r._layout.cells.tobytes() for r in js.replicas]
    for v, w in zip(voted, jvoted):
        for f in ("prediction", "votes", "n_replicas", "n_answered",
                  "n_agree"):
            assert getattr(v, f) == getattr(w, f), f
        for g, h in zip(v.results, w.results):
            for f in REQUEST_FIELDS:
                assert getattr(g, f) == getattr(h, f), f
    for k in _METRIC_KEYS:
        assert _same(met[k], jmet[k]), k
    assert _same(met["health"], jmet["health"])
    for mt, mj in zip(met["replicas"], jmet["replicas"]):
        assert _same(mt["reliability"], mj["reliability"])
    acc_voted = np.mean([v.prediction for v in voted] == yte)
    assert met["k"] == 5 and met["requests"] == len(Xte)
    assert len(set(grids)) > 1
    per_chip = [np.mean([v.results[i].prediction for v in voted] == yte)
                for i in range(5)]
    assert acc_voted >= min(per_chip)


def test_replicated_server_requires_positive_k(iris_models):
    with pytest.raises(ValueError):
        ReplicatedServer(iris_models[0].compiled, k=0, device="cpu")


# --------------------------------------------------------------------------
# canary & circuit breaker
# --------------------------------------------------------------------------
def test_canary_perfect_on_ideal_chip(iris_models):
    tm, jm, *_ = iris_models
    with TCAMServer(tm.compiled, config=ServeConfig(background=False),
                    device="cpu") as s, \
            jserve.TCAMServer(jm.compiled,
                              config=jserve.ServeConfig(background=False)) as j:
        assert s.run_canary() == j.run_canary() == 1.0
        assert s.health()["state"] == BreakerState.HEALTHY
        assert _same(s.health(), j.health())


def test_make_canary_expected_matches_oracle(iris_models):
    lay = iris_models[0].compiled.layout
    can = make_canary(lay, 16, np.random.default_rng(0))
    want = jrel.make_canary(lay, 16, np.random.default_rng(0))
    np.testing.assert_array_equal(can.words, want.words)
    np.testing.assert_array_equal(can.expected, want.expected)
    assert len(can) == 16
    assert (can.words[:, 0] == 0).all()
    preds = simulate(lay, can.words[:, 1:1 + lay.width]).predictions
    assert can.accuracy(preds) == 1.0


def _drive_breakers(steps):
    """Run one script of breaker calls on both packages' breakers; the
    snapshot after each step must agree.  Returns the port's breaker and
    the list of ``observe`` results."""
    b, j = CircuitBreaker(threshold=0.9), jrel.CircuitBreaker(threshold=0.9)
    out = []
    for name, *args in steps:
        r = getattr(b, name)(*args)
        assert r == getattr(j, name)(*args)
        assert _same(b.snapshot(), j.snapshot())
        out.append(r)
    return b, out


def test_breaker_state_machine():
    b, out = _drive_breakers([
        ("observe", 0.95), ("observe", 0.5), ("recovered", "repair", 0.97),
        ("observe", 0.3), ("failed", 0.3), ("observe", 0.95)])
    assert out[0] is False and out[1] is True and out[3] is True
    assert out[5] is False and b.state == BreakerState.HEALTHY
    snap = b.snapshot()
    assert snap["trips"] == 2 and snap["last_accuracy"] == 0.95


def test_breaker_recovery_reentry_transitions():
    b, out = _drive_breakers([
        ("observe", 0.5), ("failed", 0.2), ("recovered", "repair", 0.95),
        ("observe", 0.96), ("observe", 0.3), ("recovered", "scrub", 0.93),
        ("observe", 0.97), ("observe", 0.2), ("recovered", "fallback_ref", 0.92),
        ("observe", 0.99)])
    assert out == [True, None, None, False, True, None, False, True, None,
                   False]
    assert b.state == BreakerState.FALLBACK and b.trips == 3


# --------------------------------------------------------------------------
# the server's chip health
# --------------------------------------------------------------------------
def _servers(tm, jm, seed, p, **cfg):
    t = TCAMServer(tm.compiled, nonideal=NonIdealSpec(p_sa0=p, p_sa1=p),
                   rng=np.random.default_rng(seed), device="cpu",
                   config=ServeConfig(background=False, **cfg))
    j = jserve.TCAMServer(jm.compiled, nonideal=JaxSpec(p_sa0=p, p_sa1=p),
                          rng=np.random.default_rng(seed),
                          config=jserve.ServeConfig(background=False, **cfg))
    return t, j


def _assert_served_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in REQUEST_FIELDS:
            assert getattr(g, f) == getattr(w, f), f


@pytest.mark.parametrize("engine", ["ref", "mxu"])
def test_server_canary_trips_and_repairs(iris_models, engine):
    """End-to-end degradation ladder on both servers with the same rng:
    the same seeds trip, the breaker takes the same rungs, and health,
    reliability metrics and every served result agree."""
    tm, jm, Xtr, ytr, Xte, yte = iris_models
    cfg = dict(max_batch=16, engine=engine, canary_every_batches=1,
               canary_size=64)
    for seed in range(6):
        s, j = _servers(tm, jm, seed, 0.05, **cfg)
        acc = s.run_canary()
        assert acc == j.run_canary()
        if acc >= 0.9:
            s.close(), j.close()
            continue
        _assert_served_equal(s.serve(Xte), j.serve(Xte))
        h = s.health()
        assert _same(h, j.health())
        assert _same(s.metrics()["reliability"], j.metrics()["reliability"])
        assert h["breaker"]["trips"] >= 1
        assert h["state"] in (BreakerState.REPAIRED, BreakerState.FALLBACK,
                              BreakerState.FAILED)
        if h["state"] == BreakerState.REPAIRED:
            assert h["repair_attempts"] >= 1
            assert s.run_canary() >= 0.9
        if h["state"] == BreakerState.FALLBACK:
            assert h["engine"] == "ref"
            assert h["breaker"]["recovery"] == "fallback_ref"
        rel = s.metrics()["reliability"]
        assert rel["breaker_trips"] == h["breaker"]["trips"]
        assert rel["canary_runs"] > 0
        s.close(), j.close()
        return
    pytest.fail("no seed produced a tripping chip at p=5%")


def test_server_breaker_falls_back_to_ref_without_repair(iris_models):
    """With ``auto_repair=False`` the ladder's only rung is the plain
    version: the port takes it as the JAX server does and reports it."""
    tm, jm, Xtr, ytr, Xte, yte = iris_models
    cfg = dict(max_batch=16, engine="mxu", canary_every_batches=1,
               canary_size=64, auto_repair=False)
    for seed in range(6):
        s, j = _servers(tm, jm, seed, 0.05, **cfg)
        if s.run_canary() >= 0.9:
            j.close(), s.close()
            continue
        j.run_canary()
        _assert_served_equal(s.serve(Xte), j.serve(Xte))
        h = s.health()
        assert _same(h, j.health())
        assert h["engine"] == "ref" and h["repair_attempts"] == 0
        assert h["state"] in (BreakerState.FALLBACK, BreakerState.FAILED)
        s.close(), j.close()
        return
    pytest.fail("no seed produced a tripping chip at p=5%")


@pytest.mark.parametrize("engine", ["ref", "mxu"])
def test_server_self_test_and_manual_repair(iris_models, engine):
    tm, jm, Xtr, ytr, Xte, yte = iris_models
    s, j = _servers(tm, jm, 3, 0.02, engine=engine)
    rep = s.self_test()
    _assert_bist_equal(rep, j.self_test())
    h0 = s.health()
    assert _same(h0, j.health())
    assert h0["spares_total"] > 0
    assert rep.n_defective > 0
    report = s.repair(rep)
    jreport = j.repair(rep)
    for f in dataclasses.fields(jreport):
        assert getattr(report, f.name) == getattr(jreport, f.name), f.name
    np.testing.assert_array_equal(s.live_layout.cells, j.live_layout.cells)
    assert s.engine == j.engine
    assert _same(s.health(), j.health())
    assert s.metrics()["reliability"]["repairs"] == 1
    assert s.health()["spares_free"] <= h0["spares_free"]
    assert s.self_test().n_defective == 0
    _assert_served_equal(s.serve(Xte), j.serve(Xte))
    assert _same(s.metrics()["reliability"], j.metrics()["reliability"])
    s.close(), j.close()


def test_repair_rebuilds_the_device_operands(iris_models):
    """A repair that changes the served grid drops the operands built from
    the old grid: the next batch matches the repaired grid."""
    tm, *_, Xte, _ = iris_models
    s = TCAMServer(tm.compiled, nonideal=NonIdealSpec(p_sa0=0.05, p_sa1=0.05),
                   rng=np.random.default_rng(0), device="cpu",
                   config=ServeConfig(background=False, engine="mxu"))
    s.serve(Xte[:8])
    old = s._operands["mxu"]
    s.repair()
    res = s.serve(Xte)
    assert s._operands["mxu"] is not old
    lay = s.live_layout
    from repro_torch.kernels import tcam_infer
    want = tcam_infer(lay, encode_inputs(tm.compiled.lut, Xte),
                      engine="mxu", device="cpu")
    np.testing.assert_array_equal([r.survivor for r in res], want.survivors)
    np.testing.assert_array_equal([r.prediction for r in res],
                                  want.predictions)
    s.close()


def test_repair_without_saf_mask_raises(iris_models):
    with TCAMServer(iris_models[0].compiled,
                    config=ServeConfig(background=False), device="cpu") as s:
        with pytest.raises(RuntimeError, match="stuck-at"):
            s.repair()


# --------------------------------------------------------------------------
# forest: per-bank BIST and repair
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served_forests():
    Xtr, ytr, Xte, _ = load_split("cancer")
    trees = train_forest(Xtr, ytr, n_trees=6, max_depth=6, seed=0)
    jtrees = repro.train_forest(Xtr, ytr, n_trees=6, max_depth=6, seed=0)
    return (compile_forest(trees, s=128, spare_rows=4),
            repro.compile_forest(jtrees, s=128, spare_rows=4), Xte)


@pytest.mark.parametrize("engine", ["banked", "mxu"])
def test_forest_repair_keeps_serving(served_forests, engine):
    ft, fj, Xte = served_forests
    ref = forest_infer_ref(ft, Xte[:48])
    kw = dict(rng=np.random.default_rng(11))
    srv = TCAMServer(ft, nonideal=NonIdealSpec(p_sa0=0.01, p_sa1=0.01),
                     config=ServeConfig(engine=engine, max_batch=16,
                                        background=False),
                     device="cpu", **kw)
    jsrv = repro.TCAMServer(
        fj, nonideal=JaxSpec(p_sa0=0.01, p_sa1=0.01),
        config=repro.ServeConfig(engine=engine, max_batch=16,
                                 background=False),
        rng=np.random.default_rng(11))
    bists = srv.self_test()
    jbists = jsrv.self_test()
    assert len(bists) == len(jbists) == ft.n_banks
    for g, w in zip(bists, jbists):
        _assert_bist_equal(g, w)
    assert sum(b.defective_rows.size for b in bists) > 0
    reports = srv.repair(bists)
    jreports = jsrv.repair(jbists)
    assert len(reports) == len(jreports)
    for g, w in zip(reports, jreports):
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), f.name
    assert sum(r.rows_repaired for r in reports) > 0
    for rm, jrm in zip(srv._f_row_map, jsrv._f_row_map):
        np.testing.assert_array_equal(rm, jrm)
    got, want = srv.serve(Xte[:48]), jsrv.serve(Xte[:48])
    _assert_served_equal(got, want)
    preds = np.array([r.prediction for r in got])
    assert (preds == ref.predictions).mean() > 0.9
    health = srv.health()
    assert _same(health, jsrv.health())
    assert health["n_banks"] == ft.n_banks
    assert 1 <= health["banks_enabled"] <= ft.n_banks
    srv.close(), jsrv.close()
