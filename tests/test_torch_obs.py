"""``repro_torch.obs``: the spans inside the serving and train steps, where
each opens and what it holds, the MoE counters against values computed
here from ``route`` and ``capacity``, and that with the spans off the step
makes no profiler call and no counter operation and computes the same
bits as with them on."""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs import get_reduced
from repro_torch.models import init_cache, init_params, moe
from repro_torch.optim import AdamWConfig
from repro_torch.pytree import tree_leaves
from repro_torch.train import (build_decode_step, build_prefill_step,
                               build_train_step, init_train_state)

B, S = 2, 32


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with the spans off and no counts."""
    obs.enable(False)
    obs.reset()
    yield
    obs.enable(False)
    obs.reset()


@pytest.fixture(scope="module")
def qwen():
    cfg = get_reduced("qwen3_moe_235b_a22b")
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, tokens


@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced("olmo_1b")
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    return cfg, batch


def _serve(cfg, params, tokens):
    """Prefill, then one decode step: (prefill logits, decode logits,
    caches)."""
    caches = init_cache(cfg, B, S + 1, device="cpu")
    logits, caches = build_prefill_step(cfg)(params, {"tokens": tokens},
                                             caches)
    tok = logits[:, -1:].argmax(-1)
    dlogits, caches = build_decode_step(cfg)(params, tok, caches, S)
    return logits, dlogits, caches


def _train(cfg, batch):
    state = init_train_state(cfg, 0, device="cpu")
    step = build_train_step(cfg, AdamWConfig(), remat="none")
    return step(state, batch)


def _spans(prof) -> dict:
    """Program span name -> its host (start, end, thread) ranges."""
    out = collections.defaultdict(list)
    for e in prof.events():
        if e.name in obs.SPANS:
            out[e.name].append((e.time_range.start, e.time_range.end,
                                e.thread))
    return out


def _inside(inner, outer) -> bool:
    """Every range of ``inner`` lies in a range of ``outer`` on its
    thread."""
    return all(any(a0 <= a and b <= b0 and t == t0 for a0, b0, t0 in outer)
               for a, b, t in inner)


def test_off_span_is_one_shared_null_context():
    assert not obs.enabled()
    a, b = obs.span("lm.moe"), obs.span("step.train")
    assert a is b and isinstance(a, contextlib.nullcontext)
    obs.enable(True)
    assert obs.enabled() and obs.span("lm.moe") is not a


def test_off_profiled_prefill_records_no_program_span(qwen):
    cfg, params, tokens = qwen
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build_prefill_step(cfg)(params, {"tokens": tokens},
                                init_cache(cfg, B, S, device="cpu"))
    names = {e.name for e in prof.events()}
    assert names and not names & set(obs.SPANS)


def test_serving_spans_nest_as_documented(qwen):
    cfg, params, tokens = qwen
    obs.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(cfg, params, tokens)
    sp = _spans(prof)
    steps = sp["step.prefill"] + sp["step.decode"]
    assert len(sp["step.prefill"]) == len(sp["step.decode"]) == 1
    layers = 2 * cfg.n_layers                  # prefill's and decode's
    assert len(sp["lm.attention"]) == len(sp["lm.moe"]) == layers
    assert len(sp["moe.cast"]) == layers       # serving: once per call
    for child in ("moe.route", "moe.dispatch", "moe.experts",
                  "moe.combine", "moe.cast"):
        assert sp[child] and _inside(sp[child], sp["lm.moe"]), child
    assert _inside(sp["lm.moe"], steps)
    assert _inside(sp["lm.attention"], steps)
    assert not _inside(sp["lm.attention"], sp["lm.moe"])


def test_train_spans_nest_as_documented(olmo):
    cfg, batch = olmo
    obs.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(cfg, batch)
    sp = _spans(prof)
    assert len(sp["step.train"]) == 1
    for name in ("train.forward", "train.backward", "train.update"):
        assert len(sp[name]) == 1 and _inside(sp[name], sp["step.train"])
    assert len(sp["lm.attention"]) == cfg.n_layers
    assert _inside(sp["lm.attention"], sp["train.forward"])
    (f0, f1, _), = sp["train.forward"]
    (b0, b1, _), = sp["train.backward"]
    (u0, u1, _), = sp["train.update"]
    assert f1 <= b0 and b1 <= u0
    assert not sp["lm.moe"]                    # olmo is dense


def test_outputs_are_bit_identical_with_spans_on_and_off(qwen, olmo):
    cfg, params, tokens = qwen
    off = _serve(cfg, params, tokens)
    obs.enable(True)
    on = _serve(cfg, params, tokens)
    for a, b in zip(off[:2], on[:2]):
        assert torch.equal(a, b)
    for kind in off[2]:
        for name in off[2][kind]:
            assert torch.equal(off[2][kind][name], on[2][kind][name])
    tcfg, batch = olmo
    obs.enable(False)
    s_off, m_off = _train(tcfg, batch)
    obs.enable(True)
    s_on, m_on = _train(tcfg, batch)
    for a, b in ((s_off.params, s_on.params), (s_off.opt.mu, s_on.opt.mu),
                 (s_off.opt.nu, s_on.opt.nu)):
        assert all(torch.equal(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert torch.equal(s_off.opt.step, s_on.opt.step)
    assert torch.equal(m_off["loss"], m_on["loss"])


class _Ops(TorchDispatchMode):
    """The aten (and profiler) operations run under it, with their tensor
    arguments' dtypes and ranks."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((str(func), tuple(
            (a.dtype, a.dim()) for a in args if isinstance(a, torch.Tensor))))
        return func(*args, **(kwargs or {}))


def _counter_ops(ops) -> tuple:
    """(sums of a bool tensor, in-place adds into a 0-d int64 tensor,
    profiler calls) among ``ops``."""
    sums = sum(1 for f, a in ops if f == "aten.sum.default"
               and a[0][0] == torch.bool)
    adds = sum(1 for f, a in ops if f == "aten.add_.Tensor"
               and a[0] == (torch.int64, 0))
    prof = sum(1 for f, _ in ops if f.startswith("profiler."))
    return sums, adds, prof


def test_off_step_runs_no_profiler_call_and_no_counter_op(qwen):
    cfg, params, tokens = qwen
    step = build_prefill_step(cfg)
    recorded = {}
    for on in (False, True):
        obs.enable(on)
        with _Ops() as rec:
            step(params, {"tokens": tokens},
                 init_cache(cfg, B, S, device="cpu"))
        recorded[on] = rec.ops
    calls = cfg.n_layers        # _experts calls: one pass a layer call
    assert _counter_ops(recorded[False]) == (0, 0, 0)
    sums, adds, prof = _counter_ops(recorded[True])
    assert sums == adds == calls and prof > 0


def _ranks(top_i: torch.Tensor) -> list:
    """Each dispatch's arrival number within its expert, token order."""
    seen = collections.Counter()
    out = []
    for e in top_i.reshape(-1).tolist():
        out.append(seen[e])
        seen[e] += 1
    return out


@pytest.mark.parametrize("groups,cf", [(8, 1.25), (1, 0.5)],
                         ids=["cell", "dropping"])
def test_moe_counters_equal_routes_and_capacity(qwen, groups, cf):
    cfg, params, tokens = qwen
    cfg = dataclasses.replace(cfg, moe_groups=groups, capacity_factor=cf)
    routed = []
    real = moe.route

    def spy(xt, *a, **kw):
        out = real(xt, *a, **kw)
        routed.append(out[1])
        return out

    with mock.patch.object(moe, "route", spy), \
            profile(activities=[ProfilerActivity.CPU]):
        # counted while a profiler records, the spans left off
        _serve(cfg, params, tokens)
    got = obs.counters()
    want = collections.Counter()
    for top_i in routed:          # serving: one call per layer call
        g = groups if top_i.shape[0] % groups == 0 else 1
        want["moe.passes"] += 1
        want["moe.pass_groups"] += g
        for grp in top_i.reshape(g, -1, top_i.shape[1]):
            t, k = grp.shape
            c = moe.capacity(cfg, t)
            want["moe.dispatched"] += t * k
            want["moe.kept"] += sum(1 for r in _ranks(grp) if r < c)
            want["moe.slots"] += cfg.n_experts * c
    assert len(routed) == cfg.n_layers * 2              # prefill + decode
    assert {k: got[k] for k in obs.COUNTERS} == dict(want)
    if cf < 1:
        assert want["moe.kept"] < want["moe.dispatched"]


def test_counts_nothing_off_and_reset_clears():
    obs.add("moe.slots", 3)
    obs.add("moe.kept", torch.tensor(2))
    assert obs.counters() == {}
    obs.enable(True)
    obs.add("moe.slots", 3)
    obs.add("moe.kept", torch.tensor(2))
    obs.add("moe.kept", torch.tensor(1))
    assert obs.counters() == {"moe.slots": 3, "moe.kept": 3}
    obs.reset()
    assert obs.counters() == {}
