"""The port's single-tree ``TCAMServer`` (on the CPU) against the JAX
package's, request by request, ideal and non-ideal with equal seeds; then
the serving behaviour of the single-tree cases of ``test_serve.py``: bucket
padding, bounded builds, the warned packed->mxu fallback, shedding,
deadlines, retries and worker survival."""
import threading
import time

import numpy as np
import pytest

import repro.serve as jserve
from repro.core import DT2CAM as JaxDT2CAM
from repro.core import NonIdealSpec as JaxSpec
from repro.dt import load_split
from repro_torch.core import DT2CAM, DriftSpec, NonIdealSpec
from repro_torch.serve import (ComputeFailed, DeadlineExceeded, Rejected,
                               ServeConfig, TCAMServer)

RESULT_FIELDS = ("prediction", "survivor", "n_survivors", "active_evals",
                 "energy_j", "bucket", "engine")


@pytest.fixture(scope="module")
def iris_models():
    Xtr, ytr, Xte, yte = load_split("iris")
    return (DT2CAM(s=16, max_depth=5).fit(Xtr, ytr),
            JaxDT2CAM(s=16, max_depth=5).fit(Xtr, ytr), Xte, yte)


@pytest.fixture(scope="module")
def iris_model(iris_models):
    m, _, Xte, yte = iris_models
    return m, Xte, yte


def _server(m, **kw):
    cfg = kw.pop("config", None) or ServeConfig(background=False)
    return TCAMServer(m.compiled, config=cfg, device="cpu", **kw)


def _serve_both(tm, jm, X, nonideal=None, seed=5, **cfg):
    kw_t = dict(rng=np.random.default_rng(seed))
    kw_j = dict(rng=np.random.default_rng(seed))
    if nonideal is not None:
        kw_t["nonideal"] = NonIdealSpec(**nonideal)
        kw_j["nonideal"] = JaxSpec(**nonideal)
    with TCAMServer(tm.compiled, config=ServeConfig(background=False, **cfg),
                    device="cpu", **kw_t) as ts, \
            jserve.TCAMServer(jm.compiled,
                              config=jserve.ServeConfig(background=False, **cfg),
                              **kw_j) as js:
        got, want = ts.serve(X), js.serve(X)
        if nonideal and nonideal.get("sigma_in"):
            got += ts.serve(X)              # per-batch noise keeps in step
            want += js.serve(X)
    return got, want


def _assert_requests_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in RESULT_FIELDS:
            assert getattr(g, f) == getattr(w, f), f


@pytest.mark.parametrize("engine", ["auto", "mxu", "ref"])
def test_ideal_requests_equal_the_jax_server(iris_models, engine):
    tm, jm, Xte, _ = iris_models
    got, want = _serve_both(tm, jm, np.tile(Xte, (3, 1)), max_batch=16,
                            engine=engine)
    _assert_requests_equal(got, want)


@pytest.mark.parametrize("nonideal", [
    dict(p_sa0=0.01, p_sa1=0.01),
    dict(sa_sigma=0.03),
    dict(sigma_in=0.03),
    dict(p_sa0=0.02, p_sa1=0.01, sa_sigma=0.03, sigma_in=0.02),
])
def test_nonideal_requests_equal_the_jax_server(iris_models, nonideal):
    """Same seed, default canary_size: SAF, SA offsets, the canary and the
    per-batch noise are drawn in the same order on both servers."""
    tm, jm, Xte, _ = iris_models
    got, want = _serve_both(tm, jm, np.tile(Xte, (2, 1)), nonideal=nonideal,
                            max_batch=64)
    _assert_requests_equal(got, want)


def test_packed_requests_equal_the_jax_server():
    Xtr, ytr, Xte, _ = load_split("cancer")
    tm = DT2CAM(s=32, max_depth=8).fit(Xtr, ytr)
    jm = JaxDT2CAM(s=32, max_depth=8).fit(Xtr, ytr)
    got, want = _serve_both(tm, jm, Xte, max_batch=32, engine="packed")
    assert {r.engine for r in got} == {"packed"}
    _assert_requests_equal(got, want)


def test_served_results_equal_one_shot_infer(iris_model):
    m, Xte, _ = iris_model
    n_requests = 1024
    cfg = ServeConfig(max_batch=64, min_bucket=8, background=False)
    srv = _server(m, config=cfg)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(Xte), size=n_requests)
    futs, sent = [], 0
    while sent < n_requests:                     # bursty arrivals
        take = idx[sent: sent + int(rng.integers(1, 2 * cfg.max_batch))]
        futs += srv.submit_many(Xte[take])
        sent += len(take)
        while srv.pump(force=True):
            pass
    srv.drain()
    res = [f.result() for f in futs]
    stats = srv.metrics()
    assert stats["requests_served"] == n_requests
    assert stats["build_cache"]["misses"] <= len(srv.policy.buckets)
    assert (stats["build_cache"]["hits"]
            == stats["batches"] - stats["build_cache"]["misses"])
    assert len({r.bucket for r in res}) > 1
    ref = m.infer(Xte[idx], backend="torch", device="cpu")
    np.testing.assert_array_equal([r.prediction for r in res], ref.predictions)
    np.testing.assert_array_equal([r.energy_j for r in res], ref.energy_per_dec)
    srv.close()


def test_bucket_padding_and_warmup_build_count(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(max_batch=32, min_bucket=8, background=False)
    srv = _server(m, config=cfg)
    assert srv.policy.buckets == (8, 16, 32)
    assert srv.warmup() == len(srv.policy.buckets)
    assert srv.warmup() == 0                     # second call: all hits
    res = srv.serve(Xte[:5])
    assert {r.bucket for r in res} == {8}
    stats = srv.metrics()
    assert stats["padded_slots"] == 3 and stats["build_cache"]["misses"] == 3
    srv.close()


def test_server_honors_compile_cache_size(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(background=False, max_batch=64, min_bucket=8,
                      engine="ref", compile_cache_size=2)
    srv = _server(m, config=cfg)
    srv.warmup()                                 # 4 buckets through size-2 LRU
    st = srv.cache.stats()
    assert st["size"] <= 2 and st["evictions"] >= 2
    assert len(srv.serve(Xte[:5])) == 5          # evicted shapes rebuild fine
    srv.close()


def test_engine_fallback_when_packed_illegal(iris_model):
    m, Xte, _ = iris_model                       # s=16: packed illegal
    cfg = ServeConfig(engine="packed", background=False, max_batch=8)
    with pytest.warns(RuntimeWarning, match="falling back"):
        srv = _server(m, config=cfg)
    assert srv.engine == "mxu"
    res = srv.serve(Xte[:5])
    assert len(res) == 5 and all(r.engine == "mxu" for r in res)
    assert srv.metrics()["engine_fallbacks"] == 1
    srv.close()


def test_later_slices_raise_not_implemented(iris_model):
    m, Xte, _ = iris_model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _server(m, config=ServeConfig(background=False, canary_every_batches=1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _server(m, nonideal=NonIdealSpec(drift=DriftSpec(nu=0.05)))
    srv = _server(m)
    for call in (srv.run_canary, srv.self_test, srv.repair, srv.rollback,
                 lambda: srv.advance_time(1.0), srv.scrub_now,
                 lambda: srv.stage(m.compiled), srv.promote):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    srv.close()


def test_background_worker_futures_and_deadline_flush(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(max_batch=512, min_bucket=4, max_delay_s=0.01)
    with _server(m, config=cfg) as srv:
        futs = srv.submit_many(Xte[:3])          # far below max_batch
        res = [f.result(timeout=30) for f in futs]   # deadline must flush
        assert all(r.bucket == 4 for r in res)
        stats = srv.metrics()
        assert stats["deadline_flushes"] >= 1
        assert stats["requests_served"] == 3


def test_submit_after_close_rejected(iris_model):
    m, Xte, _ = iris_model
    srv = _server(m)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(Xte[0])


def test_concurrent_submitters_background(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(max_batch=32, min_bucket=8, max_delay_s=0.005)
    results = []
    lock = threading.Lock()
    with _server(m, config=cfg) as srv:
        def client(seed):
            rng = np.random.default_rng(seed)
            futs = [srv.submit(Xte[rng.integers(0, len(Xte))])
                    for _ in range(50)]
            out = [f.result(timeout=60) for f in futs]
            with lock:
                results.extend(out)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        stats = srv.metrics()
    assert len(results) == 200
    assert stats["requests_served"] == 200
    assert stats["build_cache"]["misses"] <= len(srv.policy.buckets)


def test_worker_survives_batch_compute_failure(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(max_batch=8, min_bucket=8, max_delay_s=0.001)
    with _server(m, config=cfg) as srv:
        boom = [True]

        def hook(_X):
            if boom[0]:
                raise RuntimeError("injected device fault")

        srv.fault_injection_hook = hook
        futs = srv.submit_many(Xte[:8])
        srv.drain(timeout=30)
        for f in futs:
            err = f.exception(timeout=5)
            assert isinstance(err, ComputeFailed)
            assert isinstance(err.__cause__, RuntimeError)
        assert srv._outstanding == 0
        assert srv.metrics()["reliability"]["compute_failures"] == 1
        boom[0] = False                          # worker must still be alive
        res = [f.result(timeout=30) for f in srv.submit_many(Xte[:8])]
        assert len(res) == 8 and srv._outstanding == 0


def test_sync_compute_failure_raises_and_recovers(iris_model):
    m, Xte, _ = iris_model
    srv = _server(m, config=ServeConfig(background=False, max_batch=8))

    def hook(_X):
        raise RuntimeError("injected device fault")

    srv.fault_injection_hook = hook
    futs = srv.submit_many(Xte[:4])
    with pytest.raises(ComputeFailed):           # sync mode surfaces the error
        srv.drain()
    assert all(isinstance(f.exception(), ComputeFailed) for f in futs)
    assert srv._outstanding == 0
    srv.fault_injection_hook = None
    assert len(srv.serve(Xte[:4])) == 4
    srv.close()


def test_drain_timeout_raises_with_counters_intact(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(max_batch=4, min_bucket=4, max_delay_s=0.001)
    gate = threading.Event()
    with _server(m, config=cfg) as srv:
        srv.fault_injection_hook = lambda _X: gate.wait(30)
        futs = srv.submit_many(Xte[:4])
        with pytest.raises(TimeoutError):
            srv.drain(timeout=0.1)
        gate.set()                               # un-stick the worker
        srv.drain(timeout=30)
        assert all(f.result(timeout=5) for f in futs)
        assert srv._outstanding == 0
        assert srv.metrics()["requests_served"] == 4


def test_bounded_queue_sheds_with_typed_rejection(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(max_batch=4, min_bucket=4, max_delay_s=0.001,
                      max_queue=4)
    gate = threading.Event()
    with _server(m, config=cfg) as srv:
        srv.fault_injection_hook = lambda _X: gate.wait(30)
        futs = [srv.submit(Xte[i % len(Xte)]) for i in range(30)]
        shed = [f for f in futs if f.done()
                and isinstance(f.exception(), Rejected)]
        assert shed                              # queue cap enforced
        gate.set()
        srv.drain(timeout=30)
        assert all(f.done() for f in futs)       # every future resolved
        assert srv.metrics()["reliability"]["shed"] == len(shed)


def test_request_deadline_expires_in_queue(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(max_batch=4, min_bucket=4, max_delay_s=0.001,
                      request_timeout_s=0.02)
    gate = threading.Event()
    with _server(m, config=cfg) as srv:
        srv.fault_injection_hook = lambda _X: gate.wait(30)
        futs = srv.submit_many(Xte[:12])         # batch 1 stalls; rest queue
        time.sleep(0.1)                          # queued requests expire
        gate.set()
        srv.drain(timeout=30)
        expired = [f for f in futs
                   if isinstance(f.exception(), DeadlineExceeded)]
        assert expired
        assert all(f.done() for f in futs)
        assert (srv.metrics()["reliability"]["deadline_exceeded"]
                == len(expired))


def test_deadline_fires_without_flush_trigger(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(max_batch=64, max_delay_s=10.0, request_timeout_s=0.05)
    with _server(m, config=cfg) as srv:
        fut = srv.submit(Xte[0])
        t0 = time.time()
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=5)
        assert time.time() - t0 < 2.0            # nowhere near max_delay_s
        assert srv.metrics()["reliability"]["deadline_exceeded"] == 1


def test_retry_budget_absorbs_transient_faults(iris_model):
    m, Xte, _ = iris_model
    cfg = ServeConfig(background=False, max_batch=8,
                      max_retries=3, retry_backoff_s=0.001)
    srv = _server(m, config=cfg)
    fails = [2]

    def flaky(_X):
        if fails[0] > 0:
            fails[0] -= 1
            raise RuntimeError("transient")

    srv.fault_injection_hook = flaky
    assert len(srv.serve(Xte[:8])) == 8          # recovered within budget
    rel = srv.metrics()["reliability"]
    assert rel["retries"] == 2 and rel["compute_failures"] == 0
    srv.close()
