"""The port's forest path against the JAX package's, bit for bit (tolerance:
exact — every compared array is equal, every float equal to the last bit):
the banked match for each engine (the JAX ``mxu`` engine runs its Pallas
kernel in interpret mode, as the JAX tests run it), the plan and the
compiler on native and sklearn forests, ``ForestExecutor`` on the CPU,
forest-mode ``TCAMServer`` ideal and under stuck faults and SA offsets with
equal seeds, and a forest carried across in a registry blob.
``test_torch_cuda.py`` holds the banked CUDA kernel against its plain
version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.kernels.banked as jbanked
from repro.core import NonIdealSpec as JaxSpec
from repro.core.lut import bitplanes
from repro.dt import load_split
from repro_torch import (CompiledForest, ForestExecutor, NonIdealSpec,
                         ServeConfig, TCAMServer, compile_forest,
                         forest_from_arrays, forest_figures, forest_infer_ref,
                         plan_forest, train_forest)
from repro_torch import kernels as tk
from test_kernels import SWEEP
from test_torch_cuda import banked_group

RESULT_FIELDS = ("predictions", "score", "survivors", "n_survivors",
                 "active_evals", "enabled", "engine", "figures")
REQUEST_FIELDS = ("prediction", "survivor", "n_survivors", "active_evals",
                  "energy_j", "bucket", "engine")


# --------------------------------------------------------------------------
# the banked match
# --------------------------------------------------------------------------
def _assert_banked_equal(cells, xpad, kmax, s, engine):
    want = jbanked.tcam_match_banked(cells, jnp.asarray(xpad), s,
                                     jnp.asarray(kmax), engine=engine)
    got = tk.tcam_match_banked(cells, xpad, s, kmax, engine=engine,
                               device="cpu")
    for gt, w in zip(got, want):
        assert gt.dtype == torch.int32
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w))


@pytest.mark.parametrize("engine", ["banked", "mxu", "ref"])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("rows,width,s,b", SWEEP)
def test_banked_match_equals_jax(rows, width, s, b, g, engine):
    cells, xpad, kmax = banked_group(rows, width, s, b, g)
    _assert_banked_equal(cells, xpad, kmax, s, engine)


@pytest.mark.parametrize("engine", ["banked", "mxu", "ref"])
@pytest.mark.parametrize("kind", ["zero", "pos", "masked"])
def test_banked_match_kmax_kinds_equal_jax(kind, engine):
    cells, xpad, kmax = banked_group(40, 70, 32, 33, 3, kind=kind)
    _assert_banked_equal(cells, xpad, kmax, 32, engine)


@pytest.mark.parametrize("engine", ["banked", "mxu", "ref"])
def test_banked_single_division_equals_jax(engine):
    cells, xpad, kmax = banked_group(9, 12, 16, 7, 3, pad_div=0)
    assert cells.shape[2] == 16                       # d == 1
    _assert_banked_equal(cells, xpad, kmax, 16, engine)
    _, evals = tk.tcam_match_banked(cells, xpad, 16, kmax, engine=engine,
                                    device="cpu")
    assert bool((evals == 1).all())


def test_banked_plain_equals_jax_einsum_and_pad_rows_die_first():
    cells, xpad, kmax = banked_group(120, 123, 64, 130, 3)
    is0, is1 = bitplanes(cells)
    want = jbanked.tcam_match_banked_ref(
        jnp.asarray(xpad), jnp.asarray(is0), jnp.asarray(is1), 64,
        jnp.asarray(kmax))
    got = tk.tcam_match_banked_plain(
        torch.from_numpy(xpad), torch.from_numpy(is0), torch.from_numpy(is1),
        64, torch.from_numpy(kmax))
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w))
    dead = torch.from_numpy(kmax[:, :, 0] == -1)[:, None, :].expand_as(got[0])
    assert bool((got[0][dead] == 0).all()) and bool((got[1][dead] == 1).all())


def test_banked_wrapper_checks_its_arguments():
    cells, xpad, kmax = banked_group(40, 70, 32, 8, 2)
    is0, is1 = (torch.from_numpy(p) for p in bitplanes(cells))
    x, km = torch.from_numpy(xpad), torch.from_numpy(kmax)
    with pytest.raises(ValueError, match="3-D"):
        tk.tcam_match_banked_cuda(x[0], is0, is1, km, s=32)
    with pytest.raises(TypeError, match="int32"):
        tk.tcam_match_banked_cuda(x, is0, is1, km.long(), s=32)
    with pytest.raises(ValueError, match="bank or width"):
        tk.tcam_match_banked_cuda(x[:1], is0, is1, km, s=32)
    with pytest.raises(ValueError, match="kmax shape"):
        tk.tcam_match_banked_cuda(x, is0, is1, km[:, :, :1].contiguous(), s=32)
    with pytest.raises(ValueError, match="unknown banked engine"):
        tk.tcam_match_banked(cells, xpad, 32, engine="packed", device="cpu")
    before = tk.tcam_match_banked_cuda.launches
    tk.tcam_match_banked_cuda(x, is0, is1, km, s=32)   # CPU: plain version
    assert tk.tcam_match_banked_cuda.launches == before


# --------------------------------------------------------------------------
# plan + compiler
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def native_forests():
    """cancer at S=16: three groups, with pad rows and pad divisions."""
    Xtr, ytr, Xte, _ = load_split("cancer")
    jt = repro.train_forest(Xtr, ytr, n_trees=8, max_depth=8, seed=0)
    tt = train_forest(Xtr, ytr, n_trees=8, max_depth=8, seed=0)
    return (compile_forest(tt, s=16, spare_rows=2),
            repro.compile_forest(jt, s=16, spare_rows=2), Xte)


def _assert_forests_equal(ft, fj):
    assert (ft.n_banks, ft.n_features, ft.n_classes, ft.vote, ft.cast_f32,
            ft.s) == (fj.n_banks, fj.n_features, fj.n_classes, fj.vote,
                      fj.cast_f32, fj.s)
    np.testing.assert_array_equal(ft.classes, fj.classes)
    for bt, bj in zip(ft.banks, fj.banks):
        np.testing.assert_array_equal(bt.layout.cells, bj.layout.cells)
        np.testing.assert_array_equal(bt.layout.classes, bj.layout.classes)
        np.testing.assert_array_equal(bt.lut.cells, bj.lut.cells)
        if bj.proba is None:
            assert bt.proba is None
        else:
            np.testing.assert_array_equal(bt.proba, bj.proba)


def _assert_plans_equal(pt, pj):
    assert pt.plan_id == pj.plan_id and pt.n_banks == pj.n_banks
    assert pt.n_groups == pj.n_groups
    for gt, gj in zip(pt.groups, pj.groups):
        assert (gt.s, gt.r_pad, gt.d_pad) == (gj.s, gj.r_pad, gj.d_pad)
        for f in ("bank_ids", "cells", "kmax0", "rows", "d_real"):
            np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f))


def _assert_results_equal(got, want, engine=None):
    for f in RESULT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f == "engine":
            assert g == (engine or w)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


def test_native_forest_compiles_and_plans_like_jax(native_forests):
    ft, fj, Xte = native_forests
    _assert_forests_equal(ft, fj)
    pt, pj = plan_forest(ft), repro.plan_forest(fj)
    _assert_plans_equal(pt, pj)
    assert pt.n_groups == 3
    assert any((g.rows < g.r_pad).any() and (g.d_real < g.d_pad).any()
               for g in pt.groups)
    assert forest_figures(ft.layouts) == repro.forest_figures(fj.layouts)
    _assert_results_equal(forest_infer_ref(ft, Xte),
                          repro.forest_infer_ref(fj, Xte))


@pytest.fixture(scope="module", params=["cancer", "car"])
def rf_case(request):
    sklearn_ensemble = pytest.importorskip("sklearn.ensemble")
    Xtr, ytr, Xte, _ = load_split(request.param)
    rf = sklearn_ensemble.RandomForestClassifier(
        n_estimators=25, max_depth=8, random_state=0).fit(Xtr, ytr)
    return rf, compile_forest(rf, s=128), repro.compile_forest(rf, s=128), Xte


def test_sklearn_forest_soft_vote_equals_rf_predict(rf_case):
    rf, ft, fj, Xte = rf_case
    assert ft.n_banks == 25 and ft.vote == "soft" and ft.cast_f32
    _assert_forests_equal(ft, fj)
    _assert_plans_equal(plan_forest(ft), repro.plan_forest(fj))
    got = forest_infer_ref(ft, Xte)
    np.testing.assert_array_equal(got.predictions, rf.predict(Xte))
    _assert_results_equal(got, repro.forest_infer_ref(fj, Xte))
    res = ForestExecutor(ft, engine="banked", device="cpu").infer(Xte)
    np.testing.assert_array_equal(res.predictions, rf.predict(Xte))
    _assert_results_equal(res, repro.ForestExecutor(fj).infer(Xte))


def test_compile_forest_validation(native_forests):
    from repro_torch import FeatureMismatch

    ft, _, Xte = native_forests
    Xtr, ytr, _, _ = load_split("cancer")
    trees = train_forest(Xtr, ytr, n_trees=2, max_depth=4, seed=0)
    with pytest.raises(ValueError, match="vote"):
        compile_forest(trees, s=64, vote="plurality")
    with pytest.raises(TypeError, match="DecisionTree"):
        compile_forest([object()], s=64)
    with pytest.raises(FeatureMismatch, match="expects"):
        forest_infer_ref(ft, Xte[:, :-1])
    with pytest.raises(FeatureMismatch, match="expects"):
        ForestExecutor(ft, device="cpu").infer(Xte[:, :-1])


# --------------------------------------------------------------------------
# ForestExecutor
# --------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["banked", "mxu", "ref"])
def test_executor_equals_jax_executor(native_forests, engine):
    ft, fj, Xte = native_forests
    Xq = Xte[:40]
    ex = ForestExecutor(ft, engine=engine, device="cpu")
    jx = repro.ForestExecutor(fj, engine=engine)
    assert ex.warmup() == jx.warmup() == (0 if engine == "ref" else 3)
    assert ex.warmup(batch=40) == jx.warmup(batch=40)
    _assert_results_equal(ex.infer(Xq), jx.infer(Xq))
    enabled = np.ones(ft.n_banks, bool)
    enabled[[1, 4]] = False
    for kw in (dict(selective_precharge=False), dict(enabled=enabled)):
        _assert_results_equal(ex.infer(Xq, **kw), jx.infer(Xq, **kw))
    # a second call at another batch reuses the bucket's built runners
    misses = ex.cache.misses
    _assert_results_equal(ex.infer(Xq[:33]), jx.infer(Xq[:33]))
    assert ex.cache.misses == misses


def test_executor_rejects_unknown_engine(native_forests):
    with pytest.raises(ValueError, match="unknown forest engine"):
        ForestExecutor(native_forests[0], engine="packed", device="cpu")


# --------------------------------------------------------------------------
# forest-mode TCAMServer
# --------------------------------------------------------------------------
def _serve_both(ft, fj, X, nonideal=None, seed=11, disable=(), **cfg):
    kw_t = dict(rng=np.random.default_rng(seed))
    kw_j = dict(rng=np.random.default_rng(seed))
    if nonideal is not None:
        kw_t["nonideal"] = NonIdealSpec(**nonideal)
        kw_j["nonideal"] = JaxSpec(**nonideal)
    with TCAMServer(ft, config=ServeConfig(background=False, **cfg),
                    device="cpu", **kw_t) as ts, \
            repro.TCAMServer(fj, config=repro.ServeConfig(background=False,
                                                          **cfg),
                             **kw_j) as js:
        for b in disable:
            ts.disable_bank(b)
            js.disable_bank(b)
        assert ts.engine == js.engine
        assert ts.warmup() == js.warmup()
        got, want = ts.serve(X), js.serve(X)
        if nonideal and nonideal.get("sigma_in"):
            got += ts.serve(X)              # per-batch noise keeps in step
            want += js.serve(X)
        mt, mj = ts.metrics(), js.metrics()
    for k in ("modelled_mdecs_pipe", "modelled_mdecs_ensemble",
              "forest_figures", "layout", "engine", "requests_served",
              "batches"):
        assert mt[k] == mj[k], k
    return got, want


def _assert_requests_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in REQUEST_FIELDS:
            assert getattr(g, f) == getattr(w, f), f


@pytest.mark.parametrize("engine", ["auto", "banked", "mxu", "ref"])
def test_forest_server_equals_jax_server(native_forests, engine):
    ft, fj, Xte = native_forests
    got, want = _serve_both(ft, fj, Xte, max_batch=16, engine=engine)
    _assert_requests_equal(got, want)
    ref = forest_infer_ref(ft, Xte)
    np.testing.assert_array_equal([r.prediction for r in got],
                                  ref.predictions)


@pytest.mark.parametrize("nonideal", [
    dict(p_sa0=0.01, p_sa1=0.01, sa_sigma=0.05),
    dict(p_sa0=0.02, p_sa1=0.01, sa_sigma=0.03, sigma_in=0.02),
])
def test_faulted_forest_server_equals_jax_server(native_forests, nonideal):
    ft, fj, Xte = native_forests
    got, want = _serve_both(ft, fj, Xte, nonideal=nonideal, max_batch=32,
                            engine="mxu")
    _assert_requests_equal(got, want)


def test_packed_falls_back_to_banked_with_a_warning(native_forests):
    ft, fj, Xte = native_forests
    with pytest.warns(RuntimeWarning, match="not available in forest mode"):
        got, want = _serve_both(ft, fj, Xte[:20], max_batch=8,
                                engine="packed")
    assert got[0].engine == "banked"
    _assert_requests_equal(got, want)


def test_disable_bank_degrades_like_jax(native_forests):
    ft, fj, Xte = native_forests
    got, want = _serve_both(ft, fj, Xte[:32], max_batch=16, engine="banked",
                            disable=(0, 5))
    _assert_requests_equal(got, want)
    enabled = np.ones(ft.n_banks, bool)
    enabled[[0, 5]] = False
    ref = forest_infer_ref(ft, Xte[:32], enabled=enabled)
    np.testing.assert_array_equal([r.prediction for r in got],
                                  ref.predictions)
    srv = TCAMServer(ft, config=ServeConfig(background=False), device="cpu")
    for b in range(ft.n_banks - 1):
        srv.disable_bank(b)
    with pytest.raises(RuntimeError, match="last voting bank"):
        srv.disable_bank(ft.n_banks - 1)


def test_forest_server_checks_and_later_slices(native_forests):
    from repro_torch import DT2CAM, FeatureMismatch
    from repro_torch.core import DriftSpec

    ft, fj, Xte = native_forests
    srv = TCAMServer(ft, config=ServeConfig(background=False), device="cpu")
    with pytest.raises(FeatureMismatch, match="expects"):
        srv.submit(Xte[0, :-1])
    m = srv.metrics()
    assert m["modelled_mdecs_pipe"] > m["modelled_mdecs_ensemble"]
    # chip health returns what the JAX forest server returns
    js = repro.TCAMServer(fj, config=repro.ServeConfig(background=False))
    for g, w in zip(srv.self_test(), js.self_test()):
        np.testing.assert_array_equal(g.detected, w.detected)
        assert g.summary() == w.summary()
    for s in (srv, js):
        with pytest.raises(RuntimeError, match="stuck-at"):
            s.repair()
    assert {k: v for k, v in srv.health().items() if k != "breaker"} == {
        k: v for k, v in js.health().items() if k != "breaker"}
    assert srv.health()["breaker"]["state"] == js.health()["breaker"]["state"]
    p = dict(p_sa0=0.01, p_sa1=0.01)
    fs = TCAMServer(ft, nonideal=NonIdealSpec(**p), device="cpu",
                    rng=np.random.default_rng(5),
                    config=ServeConfig(background=False))
    fjs = repro.TCAMServer(fj, nonideal=JaxSpec(**p),
                           rng=np.random.default_rng(5),
                           config=repro.ServeConfig(background=False))
    for g, w in zip(fs.repair(), fjs.repair()):
        assert g.summary() == w.summary()
        assert g.assignments == w.assignments
    assert {k: v for k, v in fs.health().items() if k != "breaker"} == {
        k: v for k, v in fjs.health().items() if k != "breaker"}
    with pytest.raises(NotImplementedError, match="single-model only"):
        TCAMServer(ft, nonideal=NonIdealSpec(drift=DriftSpec(nu=0.05)),
                   config=ServeConfig(background=False), device="cpu")
    with pytest.raises(ValueError, match="unknown forest engine"):
        TCAMServer(ft, config=ServeConfig(background=False, engine="x"),
                   device="cpu")
    Xtr, ytr, _, _ = load_split("iris")
    single = TCAMServer(DT2CAM(s=16, max_depth=3).fit(Xtr, ytr).compiled,
                        config=ServeConfig(background=False), device="cpu")
    with pytest.raises(RuntimeError, match="only valid in forest mode"):
        single.disable_bank(0)


# --------------------------------------------------------------------------
# registry blob
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vote", ["hard", "soft"])
def test_forest_from_arrays_loads_a_published_forest(tmp_path, vote):
    Xtr, ytr, Xte, _ = load_split("cancer")
    trees = repro.train_forest(Xtr, ytr, n_trees=4, max_depth=6, seed=3)
    fj = repro.compile_forest(trees, s=32, vote=vote)
    reg = repro.ModelRegistry(str(tmp_path))
    v = reg.publish(fj, "forest")
    path = tmp_path / (v.version_id.replace(":", "__") + ".npz")
    with np.load(path) as z:
        ft = forest_from_arrays(z, vote=vote)
    assert isinstance(ft, CompiledForest)
    _assert_forests_equal(ft, fj)
    for engine in ("banked", "mxu"):
        _assert_results_equal(
            ForestExecutor(ft, engine=engine, device="cpu").infer(Xte),
            repro.ForestExecutor(fj, engine="banked").infer(Xte),
            engine=engine)

