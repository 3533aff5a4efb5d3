"""Batched streaming TCAM inference server on the GPU (single tree or forest).

``TCAMServer`` turns a compiled DT2CAM model into a serving engine on the
CUDA match kernels:

* request queue with adaptive batch formation — flush on max-batch fill or on
  the oldest request hitting its queueing deadline (``batching.py``);
* padding-bucket batching — every batch is zero-padded to a fixed ladder of
  shapes, so the built batch functions are bounded by
  ``len(buckets) x engines``;
* warm build cache keyed ``(bucket, engine, layout_id)`` (``cache.py``): a
  built function owns its bucket's device input buffer and shares the
  layout's device-resident operands, so a batch copies only its search words
  to the card;
* engine selection ('auto'/'mxu'/'packed'/'ref') with a warned fallback to
  'mxu' when the packed engine is illegal for the layout;
* metrics — requests served, p50/p99 queue/compute/total latency, build
  cache hits/misses, modelled nJ/dec and M dec/s (``metrics.py``).

Chip-static non-idealities (stuck-at faults, SA V_ref offsets) are sampled
once at server construction — one faulty chip serving many queries — and
per-query input noise (σ_in) is drawn per batch.  The draws come from the
server's numpy ``rng`` in the JAX package's order: stuck faults, SA offsets,
the golden canary vectors, then one σ_in draw per batch; so a port server
and a JAX server seeded alike serve identical results.

Serving protections: bounded queue with load shedding (``Rejected``),
per-request queueing deadlines (``DeadlineExceeded``) and retry-with-backoff
for transient compute failures (``ComputeFailed`` after the budget).  Every
submitted Future resolves — with a result or a typed error.

Forest mode: constructed with a ``forest.CompiledForest`` the server
shards the batch path across TCAM banks — per-group banked matches
('banked' = PyTorch ops, the default for 'auto'; 'mxu' = the bitplane CUDA
kernel with a bank grid axis; 'ref' = a per-bank loop over the oracle),
pipelined across groups, each bank with its own stuck faults and SA
offsets, and one ensemble vote per request.  ``disable_bank`` drops a bank
out of the vote and its divisor.

Not in this slice (they raise ``NotImplementedError``): the periodic canary
and its circuit-breaker ladder, BIST and spare-row repair (single tree and
forest), ``health``, drift and scrub, and shadow stage/promote/rollback.
``ROADMAP.md`` lists them as the port's later slices.

Run ``background=True`` (default) for a worker thread + Future-based
completion, or ``background=False`` for deterministic single-threaded tests
via ``pump()``/``drain()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
import warnings
from concurrent.futures import Future
from typing import TYPE_CHECKING, Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..core.compiler import CompiledDT, FeatureMismatch
from ..core.encode import encode_inputs
from ..core.energy import DEFAULT_HW, HardwareParams, f_max, forest_figures
from ..core.lut import CELL_X
from ..core.nonideal import IDEAL, NonIdealSpec, apply_saf_mask, sample_saf
from ..device import DeviceLike, resolve_device
from ..kernels.ops import (MatchOperands, _finalize, prepare_match, run_match,
                           sa_kmax, select_engine)
from ..reliability.canary import CanaryProbe, make_canary
from .batching import AdaptiveBatcher, BucketPolicy
from .cache import CompileCache
from .errors import ComputeFailed, DeadlineExceeded, Rejected
from .metrics import ServeMetrics

if TYPE_CHECKING:
    from ..forest.compiler import CompiledForest

__all__ = ["RequestResult", "ServeConfig", "TCAMServer"]

_RELIABILITY_SLICE = ("ROADMAP.md Queue A, 'Reliability, drift and lifecycle "
                      "on the torch server'")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving engine (see module docstring)."""

    max_batch: int = 256          # flush as soon as this many are pending
    max_delay_s: float = 0.002    # oldest-request queueing deadline
    min_bucket: int = 8           # smallest padded batch shape
    engine: str = "auto"          # 'auto' | 'mxu' | 'packed' | 'ref';
                                  # forests: 'auto' | 'banked' | 'mxu' | 'ref'
    background: bool = True       # worker thread vs explicit pump()/drain()
    # -- serving protections ----------------------------------------------
    max_queue: Optional[int] = None    # admission control: shed when this
                                       # many requests are already queued
    request_timeout_s: Optional[float] = None  # per-request queue deadline
    max_retries: int = 0          # transient compute failure retry budget
    retry_backoff_s: float = 0.01      # first backoff; doubles per retry
    # -- chip-health canary -------------------------------------------------
    canary_every_batches: int = 0      # periodic canary: later slice; > 0 raises
    canary_size: int = 32              # golden vectors built at construction
    # -- build cache ----------------------------------------------------------
    compile_cache_size: Optional[int] = None  # LRU bound on built batch
                                              # fns (None = unbounded)


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Per-request outcome: the decision plus its serving/modelled-hw cost."""

    prediction: int
    survivor: int                 # surviving TCAM row (-1: no match)
    n_survivors: int
    active_evals: int             # modelled active row-division evaluations
    energy_j: float               # modelled ReCAM energy for this decision
    queue_s: float                # enqueue -> batch formation
    compute_s: float              # batch dispatch -> results ready
    bucket: int                   # padded batch shape it rode in
    engine: str

    @property
    def total_s(self) -> float:
        return self.queue_s + self.compute_s


@dataclasses.dataclass
class _Request:
    x: np.ndarray
    future: Future
    deadline: Optional[float] = None   # absolute clock time; None = no limit


class TCAMServer:
    """Serve a stream of classification requests on a compiled DT2CAM model.

    >>> server = TCAMServer(model.compiled)            # on the GPU
    >>> fut = server.submit(x_row)          # -> concurrent.futures.Future
    >>> fut.result().prediction
    >>> server.metrics()["compute_latency"]["p99_ms"]
    >>> server.close()
    """

    def __init__(
        self,
        compiled: Union[CompiledDT, "CompiledForest"],
        *,
        hw: HardwareParams = DEFAULT_HW,
        nonideal: NonIdealSpec = IDEAL,
        config: ServeConfig = ServeConfig(),
        rng: Optional[np.random.Generator] = None,
        clock: Callable[[], float] = time.perf_counter,
        device: DeviceLike = None,
    ) -> None:
        # multi-bank (forest) mode: a CompiledForest shards the serving path
        # across banks (duck-typed, as the JAX package does)
        self._forest = compiled if hasattr(compiled, "banks") else None
        if self._forest is not None and nonideal.has_drift:
            raise NotImplementedError(
                "drift modelling is single-model only for now; model "
                "bank drift with per-bank TCAMServer instances"
            )
        if nonideal.has_drift:
            raise NotImplementedError(
                f"drift serving is not ported yet: {_RELIABILITY_SLICE}"
            )
        if config.canary_every_batches > 0:
            raise NotImplementedError(
                "the periodic canary and circuit breaker are not ported "
                f"yet: {_RELIABILITY_SLICE}"
            )
        self.device = resolve_device(device)
        self._hw = hw
        self._config = config
        self._spec = nonideal
        self._clock = clock
        self._rng = rng or np.random.default_rng(0)
        self.metrics_store = ServeMetrics()
        # device operands per engine (single tree) or per "engine:g<i>"
        # plan group (forest), shared by every bucket's batch function
        self._operands: dict = {}
        if self._forest is not None:
            self._init_forest_state(nonideal)
        else:
            self._init_single_state(compiled, nonideal)

        self.policy = BucketPolicy(
            max_batch=config.max_batch, min_bucket=config.min_bucket
        )
        self.cache = CompileCache(self._build, self._layout_id(),
                                  maxsize=config.compile_cache_size)
        self._model_lock = threading.RLock()

        # the canary is drawn here (its rng draws are part of the serving
        # contract); running it periodically is a later slice.  Forest mode
        # has no single golden layout and draws none, as in the JAX package
        self._canary: Optional[CanaryProbe] = None
        n_canary = min(config.canary_size, config.max_batch)
        if n_canary > 0 and self._forest is None:
            self._canary = make_canary(compiled.layout, n_canary, self._rng)
        # test/chaos seam: called with the batch's feature matrix right
        # before kernel dispatch; raising simulates a transient device fault
        self.fault_injection_hook: Optional[Callable[[np.ndarray], None]] = None

        self._batcher = AdaptiveBatcher(
            config.max_batch, config.max_delay_s,
            timeout_s=config.request_timeout_s,
        )
        self._cond = threading.Condition()
        self._outstanding = 0
        self._stop = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if config.background:
            self._thread = threading.Thread(
                target=self._worker, name="tcam-serve", daemon=True
            )
            self._thread.start()

    # -- chip state -----------------------------------------------------------
    def _init_single_state(self, compiled: CompiledDT,
                           nonideal: NonIdealSpec) -> None:
        """One logical chip, sampled faults applied once."""
        self._lut = compiled.lut
        self._n_features = compiled.tree.n_features
        layout = compiled.layout
        self._intent = np.array(layout.cells, copy=True)  # programmed content
        if nonideal.has_saf:
            mask = sample_saf(
                self._intent.shape, nonideal.p_sa0, nonideal.p_sa1, self._rng
            )
            faulted = apply_saf_mask(self._intent, mask)
            # padding columns beyond decoder+LUT width are OFF-OFF (masked,
            # physically disconnected) — stuck elements there cannot reach
            # the match line, so the served grid keeps them don't-care
            faulted[:, 1 + layout.width:] = CELL_X
            layout = dataclasses.replace(layout, cells=faulted)
        self._layout = layout
        self._kmax: Optional[np.ndarray] = None
        if nonideal.sa_sigma > 0:
            offsets = self._rng.normal(
                0.0, nonideal.sa_sigma,
                size=(layout.cells.shape[0], layout.n_cwd),
            )
            self._kmax = sa_kmax(layout, offsets, self._hw)
        self.engine = self._resolve_engine(self._config.engine)

    def _init_forest_state(self, nonideal: NonIdealSpec) -> None:
        """Forest mode: every bank is its own physical array with its own
        sampled stuck-fault mask and SA offsets, drawn bank by bank in the
        JAX package's order (all masks, then all offsets); a defective bank
        degrades the ensemble vote instead of taking down the chip."""
        forest = self._forest
        self._n_features = forest.n_features
        n = forest.n_banks
        self._f_intent = [np.array(b.layout.cells, copy=True)
                          for b in forest.banks]
        self._f_layouts = []
        for i, bank in enumerate(forest.banks):
            lay = bank.layout
            if nonideal.has_saf:
                mask = sample_saf(
                    self._f_intent[i].shape,
                    nonideal.p_sa0, nonideal.p_sa1, self._rng,
                )
                faulted = apply_saf_mask(self._f_intent[i], mask)
                faulted[:, 1 + lay.width:] = CELL_X
                lay = dataclasses.replace(lay, cells=faulted)
            self._f_layouts.append(lay)
        self._f_kmax_banks: list[Optional[np.ndarray]] = [None] * n
        if nonideal.sa_sigma > 0:
            for i, lay in enumerate(self._f_layouts):
                offsets = self._rng.normal(
                    0.0, nonideal.sa_sigma,
                    size=(lay.cells.shape[0], lay.n_cwd),
                )
                self._f_kmax_banks[i] = sa_kmax(lay, offsets, self._hw)
        self._f_enabled = np.ones(n, dtype=bool)
        # physical row -> LUT (vote-table) row; spares start unassigned (the
        # repair that remaps rules onto them is the reliability slice)
        self._f_row_map = []
        for lay in self._f_layouts:
            rm = np.full(lay.cells.shape[0], -1, dtype=np.int32)
            rm[: lay.n_rows] = np.arange(lay.n_rows, dtype=np.int32)
            self._f_row_map.append(rm)
        self._rebuild_plan()
        self.engine = self._resolve_forest_engine(self._config.engine)

    def _rebuild_plan(self) -> None:
        """Shard the served (possibly faulted) bank layouts and splice each
        bank's SA-variability kmax into its group slot."""
        from ..forest.plan import plan_forest

        self._f_plan = plan_forest(self._f_layouts)
        self._f_group_kmax = []
        for grp in self._f_plan.groups:
            km = np.array(grp.kmax0, copy=True)
            for slot, bank_id in enumerate(grp.bank_ids):
                k = self._f_kmax_banks[int(bank_id)]
                if k is not None:
                    km[slot, : k.shape[0], : k.shape[1]] = k
            self._f_group_kmax.append(km)

    # -- engine & build machinery -------------------------------------------
    def _layout_id(self) -> str:
        if self._forest is not None:
            return "forest-" + self._f_plan.plan_id
        lay = self._layout
        return hashlib.sha1(
            lay.cells.tobytes()
            + lay.classes.tobytes()
            + bytes([lay.s % 251])
        ).hexdigest()[:12]

    def _resolve_engine(self, requested: str) -> str:
        lay = self._layout
        try:
            return select_engine(lay.cells, lay.s, requested)
        except ValueError as e:
            if requested != "packed":
                raise
            # explicit packed on an illegal layout: serve anyway on mxu
            warnings.warn(
                f"requested engine 'packed' is illegal for this layout "
                f"({e}); falling back to 'mxu'",
                RuntimeWarning,
                stacklevel=3,
            )
            self.metrics_store.on_fallback()
            return "mxu"

    def _resolve_forest_engine(self, requested: str) -> str:
        """Forest engines: 'banked' (PyTorch ops), 'mxu' (the CUDA kernel
        with a bank grid axis), 'ref' (oracle).  'auto' means 'banked';
        'packed' is unrepresentable for stacked banks and falls back with a
        warning."""
        if requested == "auto":
            return "banked"
        if requested in ("banked", "mxu", "ref"):
            return requested
        if requested == "packed":
            warnings.warn(
                "engine 'packed' is not available in forest mode; "
                "falling back to 'banked'",
                RuntimeWarning,
                stacklevel=3,
            )
            self.metrics_store.on_fallback()
            return "banked"
        raise ValueError(
            f"unknown forest engine {requested!r}; expected 'auto', "
            "'banked', 'mxu' or 'ref'"
        )

    def _match_operands(self, engine: str) -> MatchOperands:
        """The live layout's device operands for one engine, moved to the
        card once and shared by every bucket's batch function."""
        ops = self._operands.get(engine)
        if ops is None:
            ops = prepare_match(self._layout.cells, self._layout.s, self._kmax,
                                engine=engine, device=self.device)
            self._operands[engine] = ops
        return ops

    def _build(self, bucket: int, engine: str):
        """One batch function per (bucket, engine): (bucket, W) padded
        search words (numpy) -> (preds, survivors, n_survivors,
        active_evals) on the device.  Forest mode builds one group runner
        per plan group instead."""
        if self._forest is not None:
            return self._build_forest(bucket, engine)
        ops = self._match_operands(engine)
        lay = self._layout
        classes = torch.from_numpy(lay.classes).to(self.device, torch.int32)
        xbuf = torch.empty((bucket, lay.n_cwd * lay.s), dtype=torch.uint8,
                           device=self.device)

        def run(xpad: np.ndarray):
            xbuf.copy_(torch.from_numpy(xpad))
            survive, evals = run_match(ops, xbuf)
            return _finalize(survive, evals, classes)

        return run

    def _build_forest(self, bucket: int, engine: str) -> list:
        """Forest compute for one (bucket, engine): one ``GroupRunner`` per
        plan group, each evaluating its whole stack of banks in a single
        banked match."""
        from ..forest.executor import build_group

        return [build_group(self._forest, self._f_plan, gi, km, engine,
                            bucket, self.device, self._operands)
                for gi, km in enumerate(self._f_group_kmax)]

    def _sync(self) -> None:
        """Wait for the device (the JAX server's ``block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def warmup(self) -> int:
        """Build every bucket's batch function for the resolved engine and
        run it once (the first run loads the CUDA kernel), so no request
        pays that cost; returns #builds."""
        before = self.cache.misses
        for b in self.policy.buckets:
            fn = self.cache.get(b, self.engine)
            if self._forest is not None:
                from ..forest.executor import run_groups
                run_groups(fn, np.zeros((b, self._n_features)),
                           self._forest.n_banks)
                continue
            w = self._layout.n_cwd * self._layout.s
            fn(np.zeros((b, w), np.uint8))
        self._sync()
        return self.cache.misses - before

    # -- request intake ----------------------------------------------------
    def submit(self, x: np.ndarray) -> Future:
        """Enqueue one feature vector; the Future resolves to a
        ``RequestResult`` once its batch has been served — or to a typed
        serving error (``Rejected`` on admission-control shedding,
        ``DeadlineExceeded`` on queue expiry, ``ComputeFailed`` after the
        retry budget)."""
        x = np.asarray(x, np.float64)
        if x.ndim != 1:
            raise ValueError(
                "TCAMServer.submit expects a 1-D feature vector, got shape "
                f"{x.shape}"
            )
        if x.shape[0] != self._n_features:
            raise FeatureMismatch(
                f"TCAMServer.submit: input has {x.shape[0]} features but the "
                f"served model expects {self._n_features}"
            )
        fut: Future = Future()
        now = self._clock()
        deadline = None
        if self._config.request_timeout_s is not None:
            deadline = now + self._config.request_timeout_s
        req = _Request(x, fut, deadline)
        with self._cond:
            if self._closed:
                raise RuntimeError("server is closed")
            if (self._config.max_queue is not None
                    and len(self._batcher) >= self._config.max_queue):
                self.metrics_store.on_shed()
                fut.set_exception(Rejected(
                    f"queue full ({self._config.max_queue} pending)"
                ))
                return fut
            self._batcher.add(req, now)
            self._outstanding += 1
            self.metrics_store.on_enqueue()
            self._cond.notify_all()
        return fut

    def submit_many(self, X: np.ndarray) -> list[Future]:
        return [self.submit(row) for row in np.asarray(X)]

    # -- batch formation & execution ---------------------------------------
    def _worker(self) -> None:
        while True:
            with self._cond:
                now = self._clock()
                while not self._stop and not self._batcher.ready(now):
                    dl = self._batcher.deadline()
                    self._cond.wait(
                        None if dl is None else max(0.0, dl - now)
                    )
                    now = self._clock()
                # fail queue-expired requests promptly — the batcher's
                # deadline() wakes us at first-expiry even when no flush is
                # due, so dead requests stop holding bounded-queue capacity
                expired = self._batcher.pop_expired(now)
                deadline_flush = len(self._batcher) < self._config.max_batch
                batch = (
                    self._batcher.pop_batch()
                    if (self._batcher.flush_due(now) or self._stop) else []
                )
                done = self._stop and not len(self._batcher) and not batch
            if expired:
                self._fail_expired(expired, now)
            if batch:
                self._process(batch, deadline_flush)
            if done:
                return

    def pump(self, *, force: bool = False) -> int:
        """Synchronous mode: process at most one due batch (``force=True``
        flushes regardless of deadline); returns #requests served."""
        with self._cond:
            now = self._clock()
            expired = self._batcher.pop_expired(now)
            due = (self._batcher.flush_due(now)
                   or (force and len(self._batcher)))
            deadline_flush = len(self._batcher) < self._config.max_batch
            batch = self._batcher.pop_batch() if due else []
        if expired:
            self._fail_expired(expired, now)
        if not batch:
            return 0
        n = len(batch)
        self._process(batch, deadline_flush)
        return n

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has been served; raises
        ``TimeoutError`` (counters intact) if it takes longer than
        ``timeout`` seconds."""
        if self._thread is None:
            while self.pump(force=True):
                pass
            return
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._outstanding == 0, timeout
            ):
                raise TimeoutError("drain timed out")

    def _fail_expired(self, expired: list, now: float) -> None:
        """Resolve expired requests with ``DeadlineExceeded`` and release
        their queue accounting."""
        for p in expired:
            p.item.future.set_exception(DeadlineExceeded(
                f"request expired after {now - p.t_enqueue:.4f}s in queue"
            ))
        self.metrics_store.on_deadline_exceeded(len(expired))
        with self._cond:
            self._outstanding -= len(expired)
            self._cond.notify_all()

    def _expire_overdue(self, batch: list) -> list:
        """Safety net at process time: fail requests that expired between
        pop and dispatch; return the still-live remainder."""
        now = self._clock()
        live, expired = [], []
        for p in batch:
            req = p.item
            if req.deadline is not None and now > req.deadline:
                expired.append(p)
            else:
                live.append(p)
        if expired:
            self._fail_expired(expired, now)
        return live

    def _process(self, batch: list, deadline_flush: bool) -> None:
        batch = self._expire_overdue(batch)
        if not batch:
            return
        delay = self._config.retry_backoff_s
        attempt = 0
        while True:
            try:
                with self._model_lock:
                    if self._forest is not None:
                        self._process_inner_forest(batch, deadline_flush)
                    else:
                        self._process_inner_single(batch, deadline_flush)
                break
            except Exception as e:
                if attempt < self._config.max_retries:
                    attempt += 1
                    self.metrics_store.on_retry()
                    time.sleep(delay)
                    delay *= 2
                    continue
                # retry budget exhausted: fail the batch's futures instead of
                # hanging drain(); the worker survives for subsequent batches
                self.metrics_store.on_compute_failure()
                err = ComputeFailed(
                    f"batch compute failed after {attempt + 1} attempt(s): {e!r}"
                )
                err.__cause__ = e
                for p in batch:
                    if not p.item.future.done():
                        p.item.future.set_exception(err)
                with self._cond:
                    self._outstanding -= len(batch)
                    self._cond.notify_all()
                if self._thread is None:  # synchronous mode: surface to caller
                    raise err
                break

    def _process_inner_single(self, batch: list, deadline_flush: bool) -> None:
        t_form = self._clock()
        reqs: Sequence[_Request] = [p.item for p in batch]
        queue_lat = np.array([t_form - p.t_enqueue for p in batch])
        n = len(reqs)
        bucket = self.policy.bucket_for(n)

        X = np.stack([r.x for r in reqs])
        if self.fault_injection_hook is not None:
            self.fault_injection_hook(X)
        if self._spec.sigma_in > 0:
            X = X + self._rng.normal(0.0, self._spec.sigma_in, size=X.shape)
        xbits = encode_inputs(self._lut, X)
        xpad = self._layout.pad_inputs(xbits)
        if bucket > n:
            xpad = np.pad(xpad, ((0, bucket - n), (0, 0)))

        fn = self.cache.get(bucket, self.engine)
        out = fn(xpad)
        self._sync()
        compute_s = self._clock() - t_form

        preds, survivors, nsurv, active = (o[:n].cpu().numpy() for o in out)
        active = active.astype(np.int64)
        energy = active.astype(np.float64) * self._hw.e_row + self._hw.e_mem

        self.metrics_store.on_batch(
            n, bucket,
            deadline_flush=deadline_flush,
            energy_j=float(energy.sum()),
            active_evals=int(active.sum()),
        )
        self.metrics_store.queue.record_many(queue_lat)
        self.metrics_store.compute.record(compute_s)
        self.metrics_store.total.record_many(queue_lat + compute_s)

        for i, req in enumerate(reqs):
            req.future.set_result(
                RequestResult(
                    prediction=int(preds[i]),
                    survivor=int(survivors[i]),
                    n_survivors=int(nsurv[i]),
                    active_evals=int(active[i]),
                    energy_j=float(energy[i]),
                    queue_s=float(queue_lat[i]),
                    compute_s=compute_s,
                    bucket=bucket,
                    engine=self.engine,
                )
            )
        with self._cond:
            self._outstanding -= n
            self._cond.notify_all()

    def _process_inner_forest(self, batch: list, deadline_flush: bool) -> None:
        """Forest-mode batch: pipelined per-group compute + vote aggregation.

        Each group runner queues its copy, banked match and per-bank
        reduction on the card and returns, so group g+1's host-side encoding
        overlaps group g; then per-bank survivors (physical rows translated
        to LUT rows) aggregate into one ensemble vote per request — disabled
        banks drop out of both the vote and the divisor."""
        from ..forest.compiler import aggregate_votes
        from ..forest.executor import run_groups

        forest = self._forest
        t_form = self._clock()
        reqs: Sequence[_Request] = [p.item for p in batch]
        queue_lat = np.array([t_form - p.t_enqueue for p in batch])
        n = len(reqs)
        bucket = self.policy.bucket_for(n)

        X = np.stack([r.x for r in reqs])
        if self.fault_injection_hook is not None:
            self.fault_injection_hook(X)
        if self._spec.sigma_in > 0:
            X = X + self._rng.normal(0.0, self._spec.sigma_in, size=X.shape)
        Xp = forest.prepare_inputs(X, who="TCAMServer")

        survivors, n_survivors, active = run_groups(
            self.cache.get(bucket, self.engine), Xp, forest.n_banks,
            self._f_row_map)
        compute_s = self._clock() - t_form

        predictions, _score = aggregate_votes(
            forest, survivors, self._f_enabled
        )
        enabled = self._f_enabled
        n_voting = int(enabled.sum())
        active_total = active[enabled].sum(axis=0)
        energy = (active_total.astype(np.float64) * self._hw.e_row
                  + n_voting * self._hw.e_mem)

        self.metrics_store.on_batch(
            n, bucket,
            deadline_flush=deadline_flush,
            energy_j=float(energy.sum()),
            active_evals=int(active_total.sum()),
        )
        self.metrics_store.queue.record_many(queue_lat)
        self.metrics_store.compute.record(compute_s)
        self.metrics_store.total.record_many(queue_lat + compute_s)

        for i, req in enumerate(reqs):
            pred = predictions[i]
            req.future.set_result(
                RequestResult(
                    prediction=(int(pred) if np.issubdtype(
                        np.asarray(pred).dtype, np.integer) else pred),
                    survivor=-1,   # ensemble decision: no single row
                    n_survivors=int((n_survivors[enabled, i] > 0).sum()),
                    active_evals=int(active_total[i]),
                    energy_j=float(energy[i]),
                    queue_s=float(queue_lat[i]),
                    compute_s=compute_s,
                    bucket=bucket,
                    engine=self.engine,
                )
            )
        with self._cond:
            self._outstanding -= n
            self._cond.notify_all()

    def disable_bank(self, bank: int) -> None:
        """Drop one bank out of the ensemble vote (degraded operation)."""
        if self._forest is None:
            raise RuntimeError("disable_bank is only valid in forest mode")
        mask = self._f_enabled.copy()
        mask[int(bank)] = False
        if not mask.any():
            raise RuntimeError("cannot disable the last voting bank")
        self._f_enabled = mask

    # -- later slices -------------------------------------------------------
    def _not_ported(self, what: str):
        raise NotImplementedError(
            f"TCAMServer.{what} is not ported yet: {_RELIABILITY_SLICE}"
        )

    def run_canary(self) -> float:
        self._not_ported("run_canary")

    def self_test(self):
        self._not_ported("self_test")

    def repair(self, *args, **kwargs):
        self._not_ported("repair")

    def health(self) -> dict:
        self._not_ported("health")

    def advance_time(self, dt: float) -> float:
        self._not_ported("advance_time")

    def scrub_now(self, *, force: bool = False):
        self._not_ported("scrub_now")

    def stage(self, candidate: CompiledDT, **kwargs) -> None:
        self._not_ported("stage")

    def promote(self, **kwargs):
        self._not_ported("promote")

    def rollback(self) -> str:
        self._not_ported("rollback")

    # -- convenience & lifecycle -------------------------------------------
    def serve(self, X: np.ndarray) -> list[RequestResult]:
        """Submit every row of X, wait for completion, return results in
        submission order."""
        futs = self.submit_many(X)
        self.drain()
        return [f.result() for f in futs]

    def metrics(self) -> dict:
        """JSON-ready snapshot: serving counters/latency + build cache +
        modelled ReCAM hardware figures of merit."""
        if self._forest is not None:
            figs = forest_figures(self._f_layouts, self._hw)
            agg = figs["aggregate"]
            return self.metrics_store.snapshot(
                engine=self.engine,
                device=str(self.device),
                buckets=list(self.policy.buckets),
                build_cache=self.cache.stats(),
                # aggregate = raw per-bank pipelined rates summed; ensemble =
                # complete forest decisions (all banks' votes needed)
                modelled_mdecs_pipe=agg["decs_pipe"] / 1e6,
                modelled_mdecs_ensemble=agg["ensemble_decs_pipe"] / 1e6,
                forest_figures=figs,
                layout={
                    "n_banks": self._f_plan.n_banks,
                    "groups": [
                        {"banks": int(g.n_banks), "r_pad": g.r_pad,
                         "d_pad": g.d_pad, "s": g.s}
                        for g in self._f_plan.groups
                    ],
                },
            )
        lay, hw = self._layout, self._hw
        fm = f_max(lay.s, hw)
        return self.metrics_store.snapshot(
            engine=self.engine,
            device=str(self.device),
            buckets=list(self.policy.buckets),
            build_cache=self.cache.stats(),
            modelled_mdecs_seq=fm / lay.n_cwd / 1e6,
            modelled_mdecs_pipe=fm / hw.pipeline_ii_cycles / 1e6,
            layout={"rows": int(lay.cells.shape[0]),
                    "width": int(lay.cells.shape[1]),
                    "s": lay.s, "n_rwd": lay.n_rwd, "n_cwd": lay.n_cwd,
                    "spares": lay.n_spares},
        )

    def close(self) -> None:
        """Flush pending requests, stop the worker, reject new submits."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
        else:
            while self.pump(force=True):
                pass

    def __enter__(self) -> "TCAMServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
