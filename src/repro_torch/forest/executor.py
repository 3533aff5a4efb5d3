"""Sharded multi-bank forest executor on the GPU.

Runs a compiled forest's execution plan on the banked match: every
``PlanGroup`` evaluates as ONE invocation over its stacked banks (engine
'mxu' = the bitplane CUDA kernel with a bank grid axis, 'banked' = the
division carry in PyTorch ops), and the groups are *pipelined*: group g's
search words go to the card from a pinned host buffer without blocking, its
kernel is queued on the current stream, and the host encodes group g+1
while the card works.  The one synchronisation comes after every group is
queued.  Engine 'ref' delegates to the pure-numpy oracle
(``forest_infer_ref``); all engines produce bit-identical survivors and
therefore bit-identical votes.

Each group's (G, B, R) match outputs are reduced per bank on the device —
first survivor, survivor count, and the active evaluations over the bank's
real rows with each row's evals clamped to the bank's real division count
(pad divisions trivially match) — so only (G, B) arrays cross to the host.

Built group runners are cached per (batch-bucket, engine, group, plan_id)
through the serving engine's ``CompileCache``, with batch sizes bucketed up
the same power-of-two ladder the server uses; a runner owns the bucket's
input buffers and shares its group's device operands with every bucket.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.encode import encode_inputs
from ..core.energy import DEFAULT_HW, HardwareParams, forest_figures
from ..device import DeviceLike, resolve_device
from ..kernels.banked import BankedOperands, prepare_banked, run_banked
from ..serve.batching import BucketPolicy
from ..serve.cache import CompileCache
from .compiler import CompiledForest, ForestResult, aggregate_votes, forest_infer_ref
from .plan import ForestPlan, PlanGroup, plan_forest

__all__ = ["ForestExecutor", "FOREST_ENGINES", "encode_group"]

FOREST_ENGINES = ("banked", "mxu", "ref")


def encode_group(
    forest: CompiledForest, group: PlanGroup, Xp: np.ndarray,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-bank encode + pad to the group's stacked shape: (G, B, W_pad).

    Each bank encodes the SAME raw inputs through its OWN thresholds — banks
    cannot share search words, which is why the stacked input carries a bank
    axis instead of broadcasting one batch.  ``out`` (uint8, that shape)
    receives the words in place, e.g. a pinned host buffer.
    """
    b = Xp.shape[0]
    if out is None:
        out = np.empty((group.n_banks, b, group.width), dtype=np.uint8)
    for slot, bank_id in enumerate(group.bank_ids):
        bank = forest.banks[int(bank_id)]
        xpad = bank.layout.pad_inputs(encode_inputs(bank.lut, Xp))
        out[slot, :, : xpad.shape[1]] = xpad
        out[slot, :, xpad.shape[1]:] = 0
    return out


def reduce_banks(
    survive: torch.Tensor,   # (G, B, R) int32
    evals: torch.Tensor,     # (G, B, R) int32, unclamped
    rows: torch.Tensor,      # (G,) real physical rows per bank slot
    d_real: torch.Tensor,    # (G,) real divisions per bank slot
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per bank slot and search word, on the device: the first surviving
    real row (-1 when none; ``argmax`` returns the first maximum), the
    survivor count, and ``min(evals, d_real)`` summed over the real rows.
    Returns (first int32, count int32, active int64), each (G, B)."""
    r = survive.shape[2]
    real = (torch.arange(r, device=survive.device)[None, :]
            < rows[:, None]).to(torch.int32)[:, None, :]        # (G, 1, R)
    sv = survive * real
    count = sv.sum(dim=2, dtype=torch.int32)
    first = torch.where(count > 0, torch.argmax(sv, dim=2).to(torch.int32), -1)
    del sv
    ev = torch.minimum(evals, d_real[:, None, None]).mul_(real)
    return first, count, ev.sum(dim=2, dtype=torch.int64)


class GroupRunner:
    """One plan group's built batch function for one batch bucket: it
    shares the group's device operands (``prepare_banked``, moved to the
    card once per engine) and owns the bucket's input buffers (pinned on
    the host for a CUDA device), reused by every call.

    ``runner(Xp)`` encodes up to ``bucket`` prepared inputs, queues the
    copy, the banked match and the per-bank reduction on the current
    stream, and returns the (G, B) device results of ``reduce_banks``
    without waiting.  The caller synchronises (reads the results) before
    calling the same runner again, since the next call rewrites its host
    buffer.
    """

    def __init__(self, forest: CompiledForest, group: PlanGroup,
                 ops: BankedOperands, bucket: int) -> None:
        self.forest, self.group, self.ops, self.bucket = (forest, group, ops,
                                                          bucket)
        device = ops.device
        size = group.n_banks * bucket * group.width
        on_card = device.type == "cuda"
        self._host = torch.empty(size, dtype=torch.uint8, pin_memory=on_card)
        self._dev = (torch.empty(size, dtype=torch.uint8, device=device)
                     if on_card else self._host)
        self.rows = torch.as_tensor(group.rows, dtype=torch.int32).to(device)
        self.d_real = torch.as_tensor(group.d_real,
                                      dtype=torch.int32).to(device)

    def __call__(self, Xp: np.ndarray):
        b = Xp.shape[0]
        if not 1 <= b <= self.bucket:
            raise ValueError(f"batch of {b} outside [1, {self.bucket}]")
        shape = (self.group.n_banks, b, self.group.width)
        n = shape[0] * b * shape[2]
        host = self._host[:n].view(shape)
        encode_group(self.forest, self.group, Xp, out=host.numpy())
        x = self._dev[:n].view(shape)
        if x.data_ptr() != host.data_ptr():
            x.copy_(host, non_blocking=True)
        survive, evals = run_banked(self.ops, x)
        return reduce_banks(survive, evals, self.rows, self.d_real)


def build_group(forest: CompiledForest, plan: ForestPlan, gi: int,
                kmax: np.ndarray, engine: str, bucket: int,
                device: torch.device, operands: dict) -> GroupRunner:
    """Group ``gi``'s runner for one (bucket, engine).  The group's device
    operands go to the card once per (engine, group), kept in ``operands``
    under ``"engine:g<i>"`` and shared by every bucket."""
    grp = plan.groups[gi]
    key = f"{engine}:g{gi}"
    ops = operands.get(key)
    if ops is None:
        ops = prepare_banked(grp.cells, grp.s, kmax, engine=engine,
                             device=device)
        operands[key] = ops
    return GroupRunner(forest, grp, ops, bucket)


def run_groups(runners, Xp: np.ndarray, n_banks: int,
               row_maps: Optional[list] = None):
    """Run each group's runner in turn (an iterable, so a lazy one builds
    group g+1 while group g is on the card), then gather the results:
    (survivors, n_survivors, active), each (n_banks, B), in bank order;
    ``row_maps[i]`` translates bank i's physical survivor rows to LUT rows."""
    b = Xp.shape[0]
    survivors = np.empty((n_banks, b), np.int32)
    n_survivors = np.empty((n_banks, b), np.int32)
    active = np.empty((n_banks, b), np.int64)
    pending = [(runner.group, runner(Xp)) for runner in runners]
    # the first read waits for the card
    for grp, out in pending:
        first, count, act = (t.cpu().numpy() for t in out)
        for slot, bank_id in enumerate(grp.bank_ids):
            i = int(bank_id)
            hit = count[slot] > 0
            rows = first[slot] if row_maps is None else row_maps[i][first[slot]]
            survivors[i] = np.where(hit, rows, -1)
            n_survivors[i] = count[slot]
            active[i] = act[slot]
    return survivors, n_survivors, active


class ForestExecutor:
    """Execute a ``CompiledForest`` on the banked match, on the card unless
    the caller asks for ``device="cpu"``.

    >>> ex = ForestExecutor(forest, engine="mxu")
    >>> res = ex.infer(X)
    >>> res.predictions, res.figures["aggregate"]["decs_pipe"]
    """

    def __init__(
        self,
        forest: CompiledForest,
        *,
        engine: str = "banked",
        hw: HardwareParams = DEFAULT_HW,
        min_bucket: int = 8,
        plan: Optional[ForestPlan] = None,
        kmax: Optional[list] = None,   # per-group (G, R, D) overrides
        device: DeviceLike = None,
    ) -> None:
        if engine not in FOREST_ENGINES:
            raise ValueError(
                f"unknown forest engine {engine!r}; "
                f"expected one of {FOREST_ENGINES}"
            )
        self.device = resolve_device(device)
        self.forest = forest
        self.engine = engine
        self.hw = hw
        self.min_bucket = min_bucket
        self.plan = plan if plan is not None else plan_forest(forest)
        self._kmax = (
            [g.kmax0 for g in self.plan.groups] if kmax is None else list(kmax)
        )
        self._operands: dict[str, BankedOperands] = {}
        self.cache = CompileCache(self._build, self.plan.plan_id)

    # -- build machinery ----------------------------------------------------
    def _build(self, bucket: int, key: str) -> GroupRunner:
        """One group runner per (batch-bucket, engine, group)."""
        engine, gi = key.rsplit(":g", 1)
        return build_group(self.forest, self.plan, int(gi),
                           self._kmax[int(gi)], engine, bucket, self.device,
                           self._operands)

    def _runners(self, bucket: int):
        return (self.cache.get(bucket, f"{self.engine}:g{gi}")
                for gi in range(self.plan.n_groups))

    def _bucket_for(self, b: int) -> int:
        top = self.min_bucket
        while top < b:
            top *= 2
        policy = BucketPolicy(max_batch=top, min_bucket=self.min_bucket)
        return policy.bucket_for(b)

    def warmup(self, batch: int = 8) -> int:
        """Build every group for one batch bucket and run it once (the first
        run loads the CUDA kernel); returns #builds."""
        if self.engine == "ref":
            return 0
        before = self.cache.misses
        bucket = self._bucket_for(batch)
        zeros = np.zeros((bucket, self.forest.n_features))
        run_groups(self._runners(bucket), zeros, self.forest.n_banks)
        return self.cache.misses - before

    # -- execution ----------------------------------------------------------
    def infer(
        self,
        X: np.ndarray,
        *,
        selective_precharge: bool = True,
        enabled: Optional[np.ndarray] = None,
    ) -> ForestResult:
        if self.engine == "ref":
            return forest_infer_ref(
                self.forest, X, hw=self.hw,
                selective_precharge=selective_precharge, enabled=enabled,
            )
        forest = self.forest
        Xp = forest.prepare_inputs(X, who="ForestExecutor.infer")
        b = Xp.shape[0]
        bucket = self._bucket_for(b)

        # pipelined: each runner queues its group's copy, match and
        # reduction and returns at once, so encoding group g+1 on the host
        # overlaps group g on the card
        survivors, n_survivors, active = run_groups(
            self._runners(bucket), Xp, forest.n_banks)
        if not selective_precharge:
            for grp in self.plan.groups:
                for slot, bank_id in enumerate(grp.bank_ids):
                    active[int(bank_id)] = (int(grp.rows[slot])
                                            * int(grp.d_real[slot]))

        predictions, score = aggregate_votes(forest, survivors, enabled)
        en = (np.ones(forest.n_banks, bool) if enabled is None
              else np.asarray(enabled, bool))
        figures = forest_figures(
            forest.layouts, self.hw,
            mean_active_evals=[float(a.mean()) for a in active],
        )
        return ForestResult(
            predictions=predictions,
            score=score,
            survivors=survivors,
            n_survivors=n_survivors,
            active_evals=active,
            enabled=en,
            engine=self.engine,
            figures=figures,
        )

    __call__ = infer
