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
server's numpy ``rng`` in the JAX package's order: stuck faults, drift
exponents, SA offsets, the golden canary vectors, then one σ_in draw per
batch; so a port server and a JAX server seeded alike serve identical
results.

Reliability layer (``reliability``): the stuck-fault state is kept as a
persistent per-element ``SAFMask``, so the server can *self-test*
(march-style BIST, every row at once on the device), *repair* (remap
defective rows onto write-verified spare rows), and *canary* itself (golden
vectors replayed through the compute path).  Serving protections: bounded
queue with load shedding (``Rejected``), per-request queueing deadlines
(``DeadlineExceeded``), retry-with-backoff for transient compute failures
(``ComputeFailed`` after the budget), and a periodic canary that trips a
circuit breaker driving the degradation ladder degraded -> scrub (under
drift) -> repair -> re-vote -> failed, on the engine it was serving (on the
CPU, as in the JAX server, an engine fallback to 'ref' comes before
failed).  Every submitted Future resolves — with a result or a typed error.

Lifecycle (``lifecycle``): ``stage()`` loads a candidate model into a shadow
slot with its own chip state and device operands, a fraction of live
batches is mirrored to it, ``promote()`` evaluates the gates and swaps it in
atomically, ``rollback()`` unstages it or reverts the last promotion.

Device operands: the live model's per-engine operands (``_operands``) and
the candidate's are built once per layout; a repair or a promotion that
changes the served grid drops them with the build cache, so no batch
matches against a stale grid on the card.

Forest mode: constructed with a ``forest.CompiledForest`` the server
shards the batch path across TCAM banks — per-group banked matches
('mxu' = the bitplane CUDA kernel with a bank grid axis, what 'auto' picks
on the card; 'banked' = PyTorch ops, what 'auto' picks on the CPU; 'ref' =
a per-bank loop over the oracle), pipelined across groups, each bank with
its own stuck faults and SA offsets, and one ensemble vote per request.
Chip health runs bank by bank: BIST and spare-row repair per bank,
survivors on remapped spare rows translated through a physical->LUT row
map back to the right vote entries, and a bank whose repair stays degraded
is disabled (drops out of the vote and the divisor).

Temporal degradation (``degradation``): with ``NonIdealSpec.drift`` set, the
chip's conductances walk on a *virtual clock* (advanced per batch via
``ServeConfig.time_per_batch_s`` or explicitly via ``advance_time``) and the
served cell grid is re-derived from the drifted readout at maintenance
epochs.  The drift exponents live on the device, and the readout, the stuck
elements' re-pinning and the per-row sensing margins are tensor ops there;
a readout that changes the served grid drops the device operands and
re-resolves the engine (drift can add or remove ``CELL_MM``).  A
``ScrubScheduler`` tracks per-row write times / read counts, and a periodic
maintenance pass (``scrub_every_batches``) refreshes out-of-margin rows
through the lifecycle ``WritePlan`` machinery — refresh energy lands in the
metrics and the pulses debit the (optionally shared) ``WearTracker``
endurance ledger.  The breaker's ladder gains a first rung: drifted ->
scrub + refresh -> canary re-vote, before BIST+repair.  Drift is
single-model only, as in the JAX server.

Run ``background=True`` (default) for a worker thread + Future-based
completion, or ``background=False`` for deterministic single-threaded tests
via ``pump()``/``drain()``.
"""
from __future__ import annotations

import dataclasses
import functools
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
from ..core.lut import CELL_1, CELL_X
from ..core.nonideal import (IDEAL, DriftModel, NonIdealSpec, SAFMask,
                             apply_saf_mask, pin_stuck, sample_drift,
                             sample_saf)
from ..device import DeviceLike, resolve_device
from ..kernels.ops import (MatchOperands, _finalize, prepare_match, run_match,
                           sa_kmax, select_engine)
from ..reliability.bist import BistReport, run_bist
from ..reliability.canary import CanaryProbe, CircuitBreaker, make_canary
from ..reliability.repair import RepairReport, repair_layout
from .batching import AdaptiveBatcher, BucketPolicy
from .cache import CompileCache
from .errors import ComputeFailed, DeadlineExceeded, Rejected
from .metrics import ServeMetrics

if TYPE_CHECKING:
    from ..degradation import ScrubReport, ScrubScheduler
    from ..forest.compiler import CompiledForest

__all__ = ["PromotionReport", "RequestResult", "ServeConfig", "TCAMServer"]


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
    # -- chip-health canary / circuit breaker ------------------------------
    canary_every_batches: int = 0      # 0 disables the periodic canary
    canary_size: int = 32              # golden vectors per canary run
    canary_threshold: float = 0.9      # trip below this canary accuracy
    auto_repair: bool = True           # breaker ladder: BIST+repair first
    # -- build cache ----------------------------------------------------------
    compile_cache_size: Optional[int] = None  # LRU bound on built batch
                                              # fns (None = unbounded)
    # -- temporal degradation (drift scrub & refresh) -----------------------
    scrub_every_batches: int = 0       # 0 disables the maintenance pass
    scrub_policy: str = "margin"       # 'margin' | 'periodic'
    scrub_margin_v: float = 0.15       # refresh rows at/below this margin [V]
    scrub_period_s: float = 3600.0     # periodic policy: refresh age [s]
    scrub_max_rows: Optional[int] = None   # rows per pass (None = unbounded)
    time_per_batch_s: float = 0.0      # virtual seconds of drift per batch


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


@dataclasses.dataclass(frozen=True)
class PromotionReport:
    """Outcome of one ``TCAMServer.promote()`` gate evaluation."""

    promoted: bool
    reason: str                   # 'promoted' | 'insufficient_shadow'
                                  # | 'disagreement' | 'canary'
    staged: bool                  # candidate still staged after the call
    shadow_batches: int
    shadow_requests: int
    shadow_disagreements: int
    disagreement_rate: float
    canary_accuracy: float        # NaN when the canary gate never ran

    def summary(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _CandidateState:
    """Shadow slot: a fully-built chip state for the staged model.

    Everything the live single-model path owns — faulted layout, programmed
    intent, persistent SAF mask, SA offsets, resolved engine, its own device
    operands and warm build cache, its golden canary — so promotion is a
    pure attribute swap with no build or sampling work inside the lock."""

    compiled: CompiledDT
    lut: object
    layout: object
    intent: np.ndarray
    saf_mask: Optional[SAFMask]
    kmax: Optional[np.ndarray]
    engine: str
    operands: dict
    cache: CompileCache
    canary: Optional[CanaryProbe]
    mirror_fraction: float
    live_batches: int = 0         # live batches seen since staging
    shadow_batches: int = 0       # of those, mirrored to the candidate
    shadow_requests: int = 0
    shadow_disagreements: int = 0
    shadow_errors: int = 0        # mirror computes that raised (live unharmed)


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
        wear=None,
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
        self.device = resolve_device(device)
        self._hw = hw
        self._config = config
        self._spec = nonideal
        self._clock = clock
        self._rng = rng or np.random.default_rng(0)
        self.metrics_store = ServeMetrics()
        # endurance ledger shared with the lifecycle subsystem: refresh
        # pulses and redeploy pulses debit the same per-cell counts
        self._wear = wear
        self._drift: Optional[DriftModel] = None
        self._scrub: Optional[ScrubScheduler] = None
        self._batches_since_scrub = 0
        # device copies of host grids the drift path reads each epoch
        # (served and base cells, the stuck mask), keyed by name and
        # rebuilt when the host object they copy is replaced
        self._dev_copies: dict = {}
        # device operands per engine (single tree) or per "engine:g<i>"
        # plan group (forest), shared by every bucket's batch function and
        # dropped whenever the served grid changes
        self._operands: dict = {}
        if self._forest is not None:
            self._init_forest_state(nonideal)
        else:
            self._init_single_state(compiled, nonideal)

        self.policy = BucketPolicy(
            max_batch=config.max_batch, min_bucket=config.min_bucket
        )
        self.cache = self._make_cache()

        # -- lifecycle: shadow slot + atomic model swap --------------------
        # every batch/canary runs its whole compute under this lock, so a
        # promotion either lands before a batch (served by the new model)
        # or after it (served by the old one) — never mid-flight
        self._model_lock = threading.RLock()
        self._candidate: Optional[_CandidateState] = None
        self._prev: Optional[dict] = None   # stashed live state for rollback

        # -- chip-health machinery ----------------------------------------
        self.breaker = CircuitBreaker(threshold=config.canary_threshold)
        self._canary: Optional[CanaryProbe] = None
        n_canary = min(config.canary_size, config.max_batch)
        if n_canary > 0 and self._forest is None:
            # forest mode has no single golden layout: bank health is
            # covered by per-bank BIST/repair instead of the canary
            self._canary = make_canary(compiled.layout, n_canary, self._rng)
        self._batches_since_canary = 0
        self._repair_reports: list[RepairReport] = []
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
        # the chip's persistent stuck-element state, kept so repair can
        # write new row content through the same stuck cells
        self._saf_mask: Optional[SAFMask] = None
        if nonideal.has_saf:
            self._saf_mask = sample_saf(
                self._intent.shape, nonideal.p_sa0, nonideal.p_sa1, self._rng
            )
            faulted = apply_saf_mask(self._intent, self._saf_mask)
            # padding columns beyond decoder+LUT width are OFF-OFF (masked,
            # physically disconnected) — stuck elements there cannot reach
            # the match line, so the served grid keeps them don't-care
            faulted[:, 1 + layout.width:] = CELL_X
            layout = dataclasses.replace(layout, cells=faulted)
        self._layout = layout
        # zero-drift served layout: the grid the chip would read back right
        # after programming; under drift the live self._layout is re-derived
        # from this base at maintenance epochs
        self._base_layout = layout
        if nonideal.has_drift:
            # imported here: degradation -> lifecycle -> registry -> convert
            # -> forest -> serve would close a cycle at import time
            from ..degradation import ScrubPolicy, ScrubScheduler
            from ..lifecycle.wear import WearTracker

            # drawn after the stuck faults and before the SA offsets: the
            # JAX server's order
            self._drift = sample_drift(
                self._intent.shape, nonideal.drift, self._rng,
                device=self.device,
            )
            if self._config.scrub_policy not in ("margin", "periodic"):
                raise ValueError(
                    f"unknown scrub_policy {self._config.scrub_policy!r}"
                )
            if self._wear is None:
                self._wear = WearTracker(self._intent.shape, hw=self._hw)
            self._scrub = ScrubScheduler(
                self._intent.shape[0],
                policy=ScrubPolicy(
                    kind=self._config.scrub_policy,
                    margin_v=self._config.scrub_margin_v,
                    period_s=self._config.scrub_period_s,
                    max_rows=self._config.scrub_max_rows,
                ),
                wear=self._wear,
                hw=self._hw,
            )
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
        self._f_masks: list[Optional[SAFMask]] = [None] * n
        self._f_layouts = []
        for i, bank in enumerate(forest.banks):
            lay = bank.layout
            if nonideal.has_saf:
                mask = sample_saf(
                    self._f_intent[i].shape,
                    nonideal.p_sa0, nonideal.p_sa1, self._rng,
                )
                self._f_masks[i] = mask
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
        # physical row -> LUT (vote-table) row; spares start unassigned and
        # inherit a LUT row when repair remaps a defective rule onto them
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
    def _layout_id(self, layout=None) -> str:
        if layout is None and self._forest is not None:
            return "forest-" + self._f_plan.plan_id
        lay = self._layout if layout is None else layout
        return hashlib.sha1(
            lay.cells.tobytes()
            + lay.classes.tobytes()
            + bytes([lay.s % 251])
        ).hexdigest()[:12]

    def _make_cache(self, builder=None, layout_id: Optional[str] = None
                    ) -> CompileCache:
        return CompileCache(
            builder if builder is not None else self._build,
            layout_id if layout_id is not None else self._layout_id(),
            maxsize=self._config.compile_cache_size,
        )

    def _resolve_engine(self, requested: str, layout=None) -> str:
        lay = self._layout if layout is None else layout
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
        """Forest engines: 'mxu' (the CUDA kernel with a bank grid axis),
        'banked' (PyTorch ops), 'ref' (oracle).  'auto' means 'mxu' on the
        card and 'banked' on the CPU; 'packed' is unrepresentable for
        stacked banks and falls back to the same with a warning."""
        by_device = "mxu" if self.device.type == "cuda" else "banked"
        if requested == "auto":
            return by_device
        if requested in ("banked", "mxu", "ref"):
            return requested
        if requested == "packed":
            warnings.warn(
                "engine 'packed' is not available in forest mode; "
                f"falling back to {by_device!r}",
                RuntimeWarning,
                stacklevel=3,
            )
            self.metrics_store.on_fallback()
            return by_device
        raise ValueError(
            f"unknown forest engine {requested!r}; expected 'auto', "
            "'banked', 'mxu' or 'ref'"
        )

    def _build(self, bucket: int, engine: str):
        """One batch function per (bucket, engine): (bucket, W) padded
        search words (numpy) -> (preds, survivors, n_survivors,
        active_evals) on the device.  Forest mode builds one group runner
        per plan group instead."""
        if self._forest is not None:
            return self._build_forest(bucket, engine)
        return self._build_for(self._layout, self._kmax, self._operands,
                               bucket, engine)

    def _build_for(self, layout, kmax, operands: dict, bucket: int,
                   engine: str):
        """Single-model batch function for an explicit chip state — shared
        by the live path and the staged candidate's own build cache.  The
        layout's device operands for ``engine`` go to the card once, kept
        in ``operands`` (the chip state's own dict) for every bucket."""
        ops: Optional[MatchOperands] = operands.get(engine)
        if ops is None:
            ops = prepare_match(layout.cells, layout.s, kmax, engine=engine,
                                device=self.device)
            operands[engine] = ops
        classes = torch.from_numpy(layout.classes).to(self.device, torch.int32)
        xbuf = torch.empty((bucket, layout.n_cwd * layout.s),
                           dtype=torch.uint8, device=self.device)

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
        if self._forest is None:
            self._warm(self.cache, self.engine,
                       self._layout.n_cwd * self._layout.s)
            return self.cache.misses - before
        from ..forest.executor import run_groups
        for b in self.policy.buckets:
            run_groups(self.cache.get(b, self.engine),
                       np.zeros((b, self._n_features)), self._forest.n_banks)
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
        self._maybe_canary()
        self._maybe_scrub()

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
        if self._scrub is not None:
            # this batch was served by the pre-advance chip state; the clock
            # ticks and the read-disturb counters accumulate afterwards
            self._scrub.advance(self._config.time_per_batch_s)
            self._scrub.note_reads(n)

        preds, survivors, nsurv, active = (o[:n].cpu().numpy() for o in out)
        # shadow deployment: mirror this (post-noise) batch to the staged
        # candidate before resolving futures — a candidate-side failure must
        # not fail, retry, or double-resolve the live batch
        cand = self._candidate
        if cand is not None and self._mirror_due(cand):
            self._shadow_mirror(cand, X, bucket, preds)
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

    # -- lifecycle: shadow deployment, promotion, rollback ------------------
    _SWAP_ATTRS = ("_lut", "_intent", "_saf_mask", "_layout", "_base_layout",
                   "_kmax", "engine", "_operands", "cache", "_canary")

    def _snapshot_model(self) -> dict:
        return {a: getattr(self, a) for a in self._SWAP_ATTRS}

    def _restore_model(self, state: dict) -> None:
        for a, v in state.items():
            setattr(self, a, v)

    @property
    def staged(self) -> bool:
        """True while a candidate model occupies the shadow slot."""
        return self._candidate is not None

    @property
    def live_intent(self) -> np.ndarray:
        """The cell content currently programmed into the chip (single-model
        mode) — the 'old' grid a lifecycle delta plan diffs against."""
        if self._forest is not None:
            raise RuntimeError(
                "live_intent is single-model only; forest intents are "
                "per-bank (see plan_forest_delta)"
            )
        return self._intent

    @property
    def live_layout(self):
        """The served (possibly faulted/repaired) layout, single-model mode."""
        if self._forest is not None:
            raise RuntimeError("live_layout is single-model only")
        return self._layout

    def _warm(self, cache: CompileCache, engine: str, width: int) -> None:
        """Build every bucket's batch function of ``cache`` and run it once."""
        for b in self.policy.buckets:
            cache.get(b, engine)(np.zeros((b, width), np.uint8))
        self._sync()

    def stage(self, candidate: CompiledDT, *,
              mirror_fraction: float = 0.25, warm: bool = True) -> None:
        """Load a candidate model into the shadow slot.

        The candidate gets its own complete chip state on the same silicon:
        the live chip's persistent SAF mask is reused when the candidate grid
        matches its shape (a delta-reprogrammed array keeps its stuck
        elements), a fresh mask is sampled when the grid was resized.  Its
        device operands are built here, once, and kept apart from the live
        model's.  From then on ``mirror_fraction`` of live batches are
        re-served through the candidate's compute path and compared
        prediction-for-prediction; ``promote()`` evaluates the gates and
        performs the atomic swap.

        ``warm=True`` builds every bucket shape for the candidate (and loads
        its kernel) so promotion introduces no pause on the serving path.
        """
        if self._forest is not None or hasattr(candidate, "banks"):
            raise NotImplementedError(
                "shadow staging is single-model only; migrate forests "
                "bank-by-bank via lifecycle.plan_forest_delta"
            )
        if not 0.0 < mirror_fraction <= 1.0:
            raise ValueError(
                f"mirror_fraction must be in (0, 1], got {mirror_fraction}"
            )
        if candidate.tree.n_features != self._n_features:
            raise FeatureMismatch(
                f"candidate expects {candidate.tree.n_features} features but "
                f"the live model serves {self._n_features}"
            )
        lay = candidate.layout
        intent = np.array(lay.cells, copy=True)
        mask: Optional[SAFMask] = None
        if self._spec.has_saf:
            if (self._saf_mask is not None
                    and self._saf_mask.shape == intent.shape):
                mask = self._saf_mask        # same physical array
            else:
                mask = sample_saf(
                    intent.shape, self._spec.p_sa0, self._spec.p_sa1,
                    self._rng,
                )
            faulted = apply_saf_mask(intent, mask)
            faulted[:, 1 + lay.width:] = CELL_X
            lay = dataclasses.replace(lay, cells=faulted)
        kmax: Optional[np.ndarray] = None
        if self._spec.sa_sigma > 0:
            offsets = self._rng.normal(
                0.0, self._spec.sa_sigma,
                size=(lay.cells.shape[0], lay.n_cwd),
            )
            kmax = sa_kmax(lay, offsets, self._hw)
        engine = self._resolve_engine(self._config.engine, lay)
        operands: dict = {}
        cache = self._make_cache(
            functools.partial(self._build_for, lay, kmax, operands),
            self._layout_id(lay),
        )
        n_canary = min(self._config.canary_size, self._config.max_batch)
        canary = (make_canary(candidate.layout, n_canary, self._rng)
                  if n_canary > 0 else None)
        cand = _CandidateState(
            compiled=candidate, lut=candidate.lut, layout=lay, intent=intent,
            saf_mask=mask, kmax=kmax, engine=engine, operands=operands,
            cache=cache, canary=canary,
            mirror_fraction=float(mirror_fraction),
        )
        if warm:
            self._warm(cache, engine, lay.n_cwd * lay.s)
        with self._model_lock:
            if self._candidate is not None:
                raise RuntimeError(
                    "a candidate is already staged; promote() or rollback() "
                    "it first"
                )
            self._candidate = cand
        self.metrics_store.on_stage()

    def _mirror_due(self, cand: _CandidateState) -> bool:
        """Deterministic traffic mirroring: batch i is mirrored whenever the
        running count crosses the next multiple of 1/fraction — exactly
        ``mirror_fraction`` of live batches, no RNG involved."""
        cand.live_batches += 1
        f = cand.mirror_fraction
        return int(cand.live_batches * f) > int((cand.live_batches - 1) * f)

    def _candidate_preds(self, cand: _CandidateState, xpad: np.ndarray,
                         n: int) -> np.ndarray:
        """Padded search words through the candidate's compute path."""
        fn = cand.cache.get(xpad.shape[0], cand.engine)
        return fn(xpad)[0][:n].cpu().numpy()

    def _shadow_mirror(self, cand: _CandidateState, X: np.ndarray,
                       bucket: int, live_preds: np.ndarray) -> None:
        n = X.shape[0]
        try:
            xbits = encode_inputs(cand.lut, X)
            xpad = cand.layout.pad_inputs(xbits)
            if bucket > n:
                xpad = np.pad(xpad, ((0, bucket - n), (0, 0)))
            preds = self._candidate_preds(cand, xpad, n)
        except Exception:
            cand.shadow_errors += 1
            return
        disagreements = int((preds != live_preds).sum())
        cand.shadow_batches += 1
        cand.shadow_requests += n
        cand.shadow_disagreements += disagreements
        self.metrics_store.on_shadow(n, disagreements)

    def _canary_words(self, canary: CanaryProbe) -> np.ndarray:
        """The canary's words zero-padded to their batch bucket."""
        n = len(canary)
        xpad = np.zeros((self.policy.bucket_for(n), canary.words.shape[1]),
                        np.uint8)
        xpad[:n] = canary.words
        return xpad

    def _run_candidate_canary(self, cand: _CandidateState) -> float:
        """Candidate golden vectors through the candidate compute path."""
        if cand.canary is None:
            return float("nan")
        preds = self._candidate_preds(cand, self._canary_words(cand.canary),
                                      len(cand.canary))
        return cand.canary.accuracy(preds)

    def promote(self, *, min_shadow_batches: int = 1,
                max_disagreement: float = 0.0) -> PromotionReport:
        """Evaluate the promotion gates; on success atomically swap the
        candidate into the live slot (the previous model, device operands
        included, is stashed for ``rollback()``).

        Gates, in order:

        1. shadow exposure — fewer than ``min_shadow_batches`` mirrored
           batches leaves the candidate *staged* (not an error: it simply
           has not seen enough traffic yet);
        2. disagreement — candidate-vs-live prediction drift above
           ``max_disagreement`` unstages the candidate (a retrained model
           legitimately disagrees; the operator sets the tolerance);
        3. candidate canary — the candidate's own golden vectors through its
           compute path must reach ``canary_threshold`` accuracy, else the
           candidate is unstaged (its chip state is unhealthy).

        The swap happens under the model lock: in-flight batches finish on
        the old model, later batches ride the new one, every Future resolves.
        """
        with self._model_lock:
            cand = self._candidate
            if cand is None:
                raise RuntimeError("no candidate staged; call stage() first")
            rate = (cand.shadow_disagreements / cand.shadow_requests
                    if cand.shadow_requests else 0.0)

            def report(promoted: bool, reason: str, staged: bool,
                       acc: float = float("nan")) -> PromotionReport:
                return PromotionReport(
                    promoted=promoted, reason=reason, staged=staged,
                    shadow_batches=cand.shadow_batches,
                    shadow_requests=cand.shadow_requests,
                    shadow_disagreements=cand.shadow_disagreements,
                    disagreement_rate=rate, canary_accuracy=acc,
                )

            if cand.shadow_batches < min_shadow_batches:
                return report(False, "insufficient_shadow", True)
            if rate > max_disagreement:
                self._candidate = None
                self.metrics_store.on_promotion(False)
                return report(False, "disagreement", False)
            acc = self._run_candidate_canary(cand)
            if cand.canary is not None and \
                    acc < self._config.canary_threshold:
                self._candidate = None
                self.metrics_store.on_promotion(False)
                return report(False, "canary", False, acc)

            self._prev = self._snapshot_model()
            self._restore_model({
                "_lut": cand.lut, "_intent": cand.intent,
                "_saf_mask": cand.saf_mask, "_layout": cand.layout,
                "_base_layout": cand.layout,
                "_kmax": cand.kmax, "engine": cand.engine,
                "_operands": cand.operands, "cache": cand.cache,
                "_canary": cand.canary,
            })
            self._candidate = None
            if self._scrub is not None:
                # the promotion reprogrammed the whole array: every row's
                # drift clock restarts at the freshly-written state
                self._scrub.note_write()
                self._refresh_served_layout()
            self.metrics_store.on_promotion(True)
            if cand.canary is not None:
                self.metrics_store.on_canary(
                    acc >= self._config.canary_threshold, acc
                )
                self.breaker.observe(acc)
            return report(True, "promoted", False, acc)

    def rollback(self) -> str:
        """Back out of the lifecycle: a staged candidate is unstaged
        (returns 'unstaged'); otherwise the model stashed by the last
        promotion, with its device operands, is swapped back in (returns
        'reverted')."""
        with self._model_lock:
            if self._candidate is not None:
                self._candidate = None
                self.metrics_store.on_rollback()
                return "unstaged"
            if self._prev is not None:
                self._restore_model(self._prev)
                self._prev = None
                self.metrics_store.on_rollback()
                return "reverted"
            raise RuntimeError(
                "nothing to roll back: no candidate staged and no previous "
                "model stashed"
            )

    # -- chip health: BIST, repair, canary, breaker ------------------------
    def self_test(self):
        """March-style BIST on the device: probe every physical row of the
        (possibly faulty) array against its programmed intent; per-row
        defect map.  Forest mode returns one ``BistReport`` per bank."""
        if self._forest is not None:
            return [
                run_bist(lay.cells, intent, used=1 + lay.width,
                         n_rows=lay.n_rows, device=self.device)
                for lay, intent in zip(self._f_layouts, self._f_intent)
            ]
        return run_bist(
            self._layout.cells, self._intent,
            used=1 + self._layout.width, n_rows=self._layout.n_rows,
            device=self.device,
        )

    def repair(
        self,
        defects: Optional[BistReport] = None,
        priority: Optional[np.ndarray] = None,
    ):
        """Spare-row repair: remap BIST-flagged rows onto write-verified
        spares, drop the device operands and the build cache, and report
        graceful degradation (``report.degraded`` when spares ran out or
        ghosts remain).

        Forest mode repairs bank by bank (``defects`` is the per-bank
        ``self_test()`` list) and returns one ``RepairReport`` per repaired
        bank; a bank whose repair stays degraded is *disabled* — it drops
        out of the ensemble vote instead of poisoning it."""
        if self._forest is not None:
            return self._repair_forest(defects)
        if self._saf_mask is None:
            raise RuntimeError(
                "repair requires a chip with sampled stuck-at faults "
                "(NonIdealSpec.has_saf)"
            )
        if defects is None:
            defects = self.self_test()
        # repair is a *programming* operation: it diffs and rewrites against
        # the base (zero-drift) grid.  Detection stayed honest — self_test
        # probed the drifted served grid, so retention-flipped rows can land
        # here too; the scrub rung runs first in _recover to avoid burning
        # spares on rows a refresh would have fixed.
        new_layout, new_intent, report = repair_layout(
            self._base_layout, self._intent, self._saf_mask,
            defects.defective_rows, priority=priority,
        )
        self._base_layout = new_layout
        self._layout, self._intent = new_layout, new_intent
        self._repair_reports.append(report)
        self.metrics_store.on_repair(report.rows_repaired)
        if self._scrub is not None:
            # the spares just written + the decoder-disabled originals were
            # all physically programmed: their drift clocks restart
            written = list(report.assignments.values()) + \
                list(np.asarray(report.blocked_rows).ravel())
            if written:
                self._scrub.note_write(written)
            self._refresh_served_layout(force=True)
        else:
            self._rebuild_compute()
        return report

    def _repair_forest(self, defects) -> list:
        if not any(m is not None for m in self._f_masks):
            raise RuntimeError(
                "repair requires a chip with sampled stuck-at faults "
                "(NonIdealSpec.has_saf)"
            )
        if defects is None:
            defects = self.self_test()
        reports = []
        for i, bist in enumerate(defects):
            if bist.defective_rows.size == 0 or self._f_masks[i] is None:
                continue
            new_layout, new_intent, report = repair_layout(
                self._f_layouts[i], self._f_intent[i], self._f_masks[i],
                bist.defective_rows,
            )
            self._f_layouts[i] = new_layout
            self._f_intent[i] = new_intent
            # spare rows inherit the LUT row they now carry, so post-repair
            # survivors (physical spare indices) resolve in vote-table space
            rm = self._f_row_map[i]
            for orig, spare in report.assignments.items():
                rm[int(spare)] = rm[int(orig)]
            reports.append(report)
            self.metrics_store.on_repair(report.rows_repaired)
            if report.degraded:
                self._f_enabled[i] = False
        self._repair_reports.extend(reports)
        self._rebuild_compute()
        return reports

    def _rebuild_compute(self) -> None:
        """After the served grid changed (repair, a drifted readout):
        re-resolve engine legality (repair writes and drift can add/remove
        CELL_MM), drop the device operands built from the old grid, and
        re-key the build cache."""
        if self._forest is not None:
            if self.engine != "ref":
                self.engine = self._resolve_forest_engine(self._config.engine)
            self._rebuild_plan()
        elif self.engine != "ref":
            self.engine = self._resolve_engine(self._config.engine)
        self._operands = {}
        self.cache = self._make_cache()

    def run_canary(self) -> float:
        """Replay the golden vectors through the live compute path; returns
        canary accuracy (and records it in the metrics)."""
        with self._model_lock:
            if self._canary is None:
                raise RuntimeError("canary disabled (canary_size <= 0)")
            xpad = self._canary_words(self._canary)
            out = self.cache.get(xpad.shape[0], self.engine)(xpad)
            preds = out[0][: len(self._canary)].cpu().numpy()
            acc = self._canary.accuracy(preds)
        self.metrics_store.on_canary(
            acc >= self._config.canary_threshold, acc
        )
        return acc

    def _maybe_canary(self) -> None:
        if self._config.canary_every_batches <= 0 or self._canary is None:
            return
        self._batches_since_canary += 1
        if self._batches_since_canary < self._config.canary_every_batches:
            return
        self._batches_since_canary = 0
        acc = self.run_canary()
        if self.breaker.observe(acc):
            self.metrics_store.on_trip()
            self._recover()

    def _recover(self) -> None:
        """Degradation ladder: scrub drifted rows, then repair the chip,
        re-voting the canary after each rung; if still failing, mark FAILED
        (the server keeps answering on the same engine — degradation stays
        graceful).

        On the CPU the JAX server's last rung stays: fall back to the 'ref'
        engine before FAILED, shown by ``health()``.  On the card there is
        no such rung: 'ref' matches the same faulted grid on the host, so it
        could restore the canary only where a kernel disagrees with its
        plain version, and it would move serving off the card for good."""
        thr = self._config.canary_threshold
        if self._scrub is not None:
            # first rung: a full refresh undoes retention/drift damage
            # without consuming spare rows — cheaper than repair when the
            # trip was temporal, a no-op-equivalent when it was stuck-at
            self.scrub_now(force=True)
            acc = self.run_canary()
            if acc >= thr:
                self.breaker.recovered("scrub", acc)
                return
        if self._config.auto_repair and self._saf_mask is not None:
            self.repair()
            acc = self.run_canary()
            if acc >= thr:
                self.breaker.recovered("repair", acc)
                return
        if self.device.type == "cpu" and self.engine != "ref":
            self.engine = "ref"
            self.cache = self._make_cache()
            acc = self.run_canary()
            if acc >= thr:
                self.breaker.recovered("fallback_ref", acc)
                return
        self.breaker.failed(self.breaker.last_accuracy)

    def health(self) -> dict:
        """Chip-health snapshot: breaker state, canary, spares, repairs."""
        if self._forest is not None:
            spares_total = sum(l.n_spares for l in self._f_layouts)
            spares_free = sum(
                int((intent[lay.spare_row_indices, 0] == CELL_1).sum())
                for lay, intent in zip(self._f_layouts, self._f_intent)
                if lay.n_spares
            )
            return {
                "state": self.breaker.state,
                "engine": self.engine,
                "breaker": self.breaker.snapshot(),
                "mode": "forest",
                "n_banks": self._forest.n_banks,
                "banks_enabled": int(self._f_enabled.sum()),
                "spares_total": spares_total,
                "spares_free": spares_free,
                "repair_attempts": len(self._repair_reports),
                "last_repair": (
                    self._repair_reports[-1].summary()
                    if self._repair_reports else None
                ),
            }
        spares_free = int(
            (self._intent[self._layout.spare_row_indices, 0] == CELL_1).sum()
        ) if self._layout.n_spares else 0
        return {
            "state": self.breaker.state,
            "engine": self.engine,
            "breaker": self.breaker.snapshot(),
            "candidate_staged": self._candidate is not None,
            "spares_total": self._layout.n_spares,
            "spares_free": spares_free,
            "repair_attempts": len(self._repair_reports),
            "last_repair": (
                self._repair_reports[-1].summary()
                if self._repair_reports else None
            ),
            "degradation": (
                self._degradation_health() if self._scrub is not None
                else None
            ),
        }

    # -- temporal degradation: drift clock, margins, scrub passes -----------
    @property
    def drift_enabled(self) -> bool:
        """True when the chip was constructed with a drift model."""
        return self._scrub is not None

    def _require_drift(self) -> ScrubScheduler:
        if self._scrub is None:
            raise RuntimeError(
                "drift modelling disabled: construct the server with "
                "NonIdealSpec(drift=DriftSpec(...))"
            )
        return self._scrub

    def _blocked_rows(self) -> np.ndarray:
        """Decoder-disabled rows from every repair so far: they carry no
        live content, so refreshing them would waste endurance."""
        if not self._repair_reports:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate([
            np.asarray(r.blocked_rows, dtype=np.int64).ravel()
            for r in self._repair_reports
        ] + [np.zeros(0, np.int64)]))

    def _compute_margins(self):
        from ..degradation import layout_margins
        return layout_margins(
            self._base_layout, self._drift,
            self._scrub.ages(), self._scrub.reads, self._hw,
        )

    def _on_device(self, key: str, obj, make):
        """The device copy ``make(obj)`` of a host object, kept under
        ``key`` and rebuilt once ``obj`` is replaced (repair, promotion)."""
        hit = self._dev_copies.get(key)
        if hit is None or hit[0] is not obj:
            hit = (obj, make(obj))
            self._dev_copies[key] = hit
        return hit[1]

    def _cells_on_device(self, key: str, layout) -> torch.Tensor:
        return self._on_device(
            key, layout, lambda lay: torch.from_numpy(lay.cells).to(
                self.device))

    def _refresh_served_layout(self, *, force: bool = False) -> None:
        """Re-derive the served grid on the device: base (programmed) layout
        -> drift readout at the rows' current stress -> stuck elements
        re-pinned -> padding columns masked.  The compute (engine, device
        operands, build cache) is only rebuilt when the readout grid
        actually changed (``force`` bypasses the comparison, e.g. right
        after a repair replaced the base layout itself)."""
        base = self._base_layout
        cells = self._drift.readout(
            self._cells_on_device("base", base),
            self._scrub.ages(), self._scrub.reads, self._hw,
        )
        if self._saf_mask is not None:
            mask = self._on_device("saf", self._saf_mask, lambda m: SAFMask(
                *(torch.from_numpy(a).to(self.device) for a in (
                    m.sa0_r1, m.sa1_r1, m.sa0_r2, m.sa1_r2))))
            cells = pin_stuck(cells, mask)
        cells[:, 1 + base.width:] = CELL_X
        if not force and torch.equal(
                cells, self._cells_on_device("served", self._layout)):
            return
        # every batch ends in a sync under the model lock, which this runs
        # under too: no launch still reads the operands dropped below
        self._sync()
        self._layout = dataclasses.replace(base, cells=cells.cpu().numpy())
        self._dev_copies["served"] = (self._layout, cells)
        self._rebuild_compute()

    def advance_time(self, dt: float) -> float:
        """Advance the drift virtual clock by ``dt`` seconds and re-derive
        the served grid (accelerated-aging campaigns drive this directly;
        live serving ticks it via ``ServeConfig.time_per_batch_s``).
        Returns the new virtual now."""
        with self._model_lock:
            sch = self._require_drift()
            now = sch.advance(dt)
            self._refresh_served_layout()
        return now

    def margins(self):
        """Per-row ``SenseMargins`` of the live chip at its current drift
        state (worst case over column divisions), computed on the device."""
        with self._model_lock:
            self._require_drift()
            return self._compute_margins()

    def scrub_now(self, *, force: bool = False) -> ScrubReport:
        """One scrub pass: policy-selected rows (``force=True``: every
        non-blocked row) are refreshed through the lifecycle ``WritePlan``
        machinery — pulses debit the wear ledger, energy/time land in the
        metrics — and the served grid is re-derived.

        Runs under the model lock, so a pass lands entirely between batches:
        in-flight requests are never dropped or double-resolved."""
        with self._model_lock:
            sch = self._require_drift()
            base = self._base_layout
            if force:
                plan, report = sch.scrub(
                    base.cells, used=1 + base.width,
                    blocked=self._blocked_rows(),
                    force_rows=np.arange(sch.n_rows),
                )
            else:
                margins = (self._compute_margins().margin
                           if sch.policy.kind == "margin" else None)
                plan, report = sch.scrub(
                    base.cells, margins, used=1 + base.width,
                    blocked=self._blocked_rows(),
                )
            self.metrics_store.on_scrub(
                report.n_refreshed,
                report.figures["energy_j"],
                report.figures["pulses"],
            )
            self._refresh_served_layout()
        return report

    def _maybe_scrub(self) -> None:
        """Background maintenance: every ``scrub_every_batches`` processed
        batches, run one policy-driven scrub pass."""
        if self._scrub is None or self._config.scrub_every_batches <= 0:
            return
        self._batches_since_scrub += 1
        if self._batches_since_scrub < self._config.scrub_every_batches:
            return
        self._batches_since_scrub = 0
        self.scrub_now()

    def _degradation_health(self) -> dict:
        snap = self._scrub.snapshot()
        snap["margins"] = self._compute_margins().summary()
        snap["blocked_rows"] = int(self._blocked_rows().size)
        if self._wear is not None:
            snap["wear"] = self._wear.snapshot()
        return snap

    # -- convenience & lifecycle -------------------------------------------
    def serve(self, X: np.ndarray) -> list[RequestResult]:
        """Submit every row of X, wait for completion, return results in
        submission order."""
        futs = self.submit_many(X)
        self.drain()
        return [f.result() for f in futs]

    def metrics(self) -> dict:
        """JSON-ready snapshot: serving counters/latency + build cache +
        chip health + modelled ReCAM hardware figures of merit."""
        if self._forest is not None:
            figs = forest_figures(self._f_layouts, self._hw)
            agg = figs["aggregate"]
            return self.metrics_store.snapshot(
                engine=self.engine,
                device=str(self.device),
                buckets=list(self.policy.buckets),
                build_cache=self.cache.stats(),
                health=self.health(),
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
            health=self.health(),
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
