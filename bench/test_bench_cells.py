"""Whole runs of each cell on the CPU at its files' ``test_sizes``: the
port's prefill, decode and train step held against the plain reference
(``correct`` true), the lower-precision control coming out not correct,
and every fault a cell can have, planted underneath the timed path,
turning ``correct`` false."""
from __future__ import annotations

import contextlib
from unittest import mock

import pytest
import torch

from bench import check
from bench.faults import half_batch
from bench.harness import run_cell
from bench.small import small_ctx

PREFILL, DECODE = "qwen3moe-l4.prefill-mix", "qwen3moe-l4.decode-b32"
TRAIN = "olmo-1b.train-8x2048"
SEEDS = (3, 2**31 + 17)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(workload, seed, **kw):
    return run_cell(small_ctx(workload, seed, seconds=0.2,
                              variant=kw.pop("variant", None)), **kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [PREFILL, DECODE])
def test_serving_matches_reference_and_control_does_not(workload, seed):
    out = _run(workload, seed, control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    ctx = small_ctx(workload, seed)
    ok, _ = check.verdict(out["control"], ctx.limits)
    assert not ok, out["control"]


@pytest.mark.parametrize("seed", SEEDS)
def test_train_step_matches_reference_and_int8_does_not(seed):
    out = _run(TRAIN, seed)
    assert out["correct"], out["checks"]
    ctl = _run(TRAIN, seed, variant="compress")
    assert not ctl["correct"], ctl["checks"]


def test_traced_run_reports_its_layers():
    out = run_cell(small_ctx(PREFILL, 5, trace=True))
    assert out["correct"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])


# ---- faults planted underneath the timed path -----------------------------
def _serving_fault(kind: str, fault: str):
    """The port's prefill or decode step with ``fault``: the caches left
    as they were, half of the rows run and their answers given to the
    other half, or every produced token altered (the logits rolled by
    one, so the greedy pick is the next id)."""
    from repro_torch.train import step as step_mod
    name = "prefill" if kind == "prefill" else "decode_step"
    whole = getattr(step_mod, name)

    def broken(params, cfg, tokens, caches, *args, **kw):
        if fault == "unchanged":
            spare = {k: {n: t.clone() for n, t in v.items()}
                     for k, v in caches.items()}
            logits, _ = whole(params, cfg, tokens, spare, *args, **kw)
            return logits, caches
        if fault == "half":
            h = max(1, tokens.shape[0] // 2)
            part = {k: {n: (t if n == "slot_pos" else t[:, :h])
                        for n, t in v.items()} for k, v in caches.items()}
            logits, _ = whole(params, cfg, tokens[:h], part, *args, **kw)
            return torch.cat([logits, logits], 0)[:tokens.shape[0]], caches
        logits, caches = whole(params, cfg, tokens, caches, *args, **kw)
        return torch.roll(logits, 1, dims=-1), caches
    return mock.patch.object(step_mod, name, broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "token"])
@pytest.mark.parametrize("workload", [PREFILL, DECODE])
def test_serving_fault_is_caught(workload, fault):
    kind = "prefill" if workload == PREFILL else "decode"
    with _serving_fault(kind, fault):
        out = _run(workload, SEEDS[0])
    assert not out["correct"], (fault, out["checks"])


def _long_row_fault(fault: str, longest: int):
    """The port's prefill wrong on its longest rows alone: the keys and
    values it writes past half of each such row taken from the slots half
    a row earlier (``past_half``), the whole batch run on its tokens read
    one position off (``longest``), or its logits rolled by one id, so
    that each greedy token is altered (``longest_head``)."""
    from repro_torch.train import step as step_mod
    whole = step_mod.prefill

    def broken(params, cfg, tokens, caches, *args, **kw):
        s = tokens.shape[1]
        if s != longest:
            return whole(params, cfg, tokens, caches, *args, **kw)
        if fault == "longest":
            tokens = torch.roll(tokens, 1, dims=1)
        logits, caches = whole(params, cfg, tokens, caches, *args, **kw)
        if fault == "longest_head":
            logits = torch.roll(logits, 1, dims=-1)
        if fault == "past_half":
            h = s // 2
            for v in caches.values():
                for n in ("k", "v"):
                    v[n][:, :, h:] = v[n][:, :, :s - h].clone()
        return logits, caches
    return mock.patch.object(step_mod, "prefill", broken)


@pytest.mark.parametrize("fault", ["past_half", "longest", "longest_head"])
def test_prefill_long_row_fault_is_caught(fault):
    longest = max(s for _, s in small_ctx(PREFILL, 0).traffic["cycle"])
    with _long_row_fault(fault, longest):
        out = _run(PREFILL, SEEDS[0])
    assert not out["correct"], (fault, out["checks"])


@contextlib.contextmanager
def _train_fault(fault: str):
    """The port's train step returning the state it was given, or taking
    its gradient over the first half of the batch's rows (their mean)."""
    from repro_torch import train as train_pkg
    if fault == "unchanged":
        build = train_pkg.build_train_step

        def frozen(*a, **kw):
            step = build(*a, **kw)

            def same(state, batch):
                _, metrics = step(state, batch)
                return state, metrics
            return same
        with mock.patch.object(train_pkg, "build_train_step", frozen):
            yield
        return
    with half_batch():
        yield


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_train_fault_is_caught(fault):
    with _train_fault(fault):
        out = _run(TRAIN, SEEDS[0])
    assert not out["correct"], (fault, out["checks"])
