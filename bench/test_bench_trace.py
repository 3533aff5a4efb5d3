"""``bench.spans.summarise`` on synthetic profiler events: idle gaps named
by harness span, program span and blocking call, summing by harness
prefix to ``bench.trace``'s attribution; device time owned by the spans
open at each operation's launch, clipped to the window; idle in blocking
calls counted only inside ``step.*``.  The ``expert_fill.*`` readers on
the program's counters, and in a CPU rehearsal of the traced cells."""
from __future__ import annotations

import importlib.util
import pathlib
from types import SimpleNamespace

import pytest
import torch

from bench import spans, trace
from bench.harness import run_cell
from bench.small import small_ctx

PROGRAM = ("step.prefill", "step.train", "train.backward", "lm.attention",
           "lm.moe", "moe.experts")
METRICS = pathlib.Path(__file__).resolve().parent / "metrics"


def ev(name, dev, a, b, thread=1, cid=0):
    """A profiler event as ``summarise`` reads it (times in us)."""
    return SimpleNamespace(name=name, device_type=SimpleNamespace(name=dev),
                           time_range=SimpleNamespace(start=a, end=b),
                           thread=thread, id=cid)


def serving_events():
    """One prefill step call: attention, then the MoE with a sync in it;
    the harness's ``sync`` after.  Kernels k1-k6 (ids 1-6) launched at
    the runtime calls' times; k6 runs past the window's end."""
    host = [ev("window", "CPU", 0, 1000), ev("step call", "CPU", 0, 800),
            ev("sync", "CPU", 800, 1000),
            ev("step.prefill", "CPU", 10, 790),
            ev("lm.attention", "CPU", 20, 300), ev("lm.moe", "CPU", 300, 780),
            ev("moe.experts", "CPU", 400, 600),
            ev("cudaStreamSynchronize", "CPU", 610, 700),
            ev("cudaDeviceSynchronize", "CPU", 810, 990)]
    launches = [(1, 25), (2, 310), (3, 410), (5, 705), (6, 770)]
    host += [ev("cudaLaunchKernel", "CPU", t, t + 3, cid=c)
             for c, t in launches]
    device = [ev("k1", "CUDA", 30, 250, cid=1), ev("k2", "CUDA", 320, 450,
                                                   cid=2),
              ev("k3", "CUDA", 460, 600, cid=3), ev("k5", "CUDA", 710, 760,
                                                    cid=5),
              ev("k6", "CUDA", 900, 1100, cid=6),
              # the spans' own copies on the device's timeline
              ev("lm.moe", "CUDA", 320, 760), ev("step call", "CUDA", 30, 760)]
    return host + device


def without_program_copies(events):
    return [e for e in events
            if not (e.name in PROGRAM and e.device_type.name == "CUDA")]


def test_gaps_named_by_program_span_and_blocking_call():
    s = spans.summarise(serving_events(), PROGRAM)
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({
        "step call/step.prefill": 30e-6,                    # 0-30
        "step call/lm.attention": 70e-6,                    # 250-320
        "step call/moe.experts": 10e-6,                     # 450-460
        "step call/lm.moe/cudaStreamSynchronize": 110e-6,   # 600-710
        "sync": 140e-6,                                     # 760-900
    })
    assert s["sync_idle_s"] == pytest.approx(110e-6)
    assert s["blocking"] == {"cudaStreamSynchronize": [1, pytest.approx(
        90e-6)], "cudaDeviceSynchronize": [1, pytest.approx(180e-6)]}
    assert s["sync_calls"] == {"lm.moe": {"cudaStreamSynchronize": 1}}


def test_gaps_by_harness_prefix_are_todays_attribution():
    events = serving_events()
    new = spans.summarise(events, PROGRAM, top=100)
    today = trace.summarise(without_program_copies(events))
    sums: dict = {}
    for name, t in new["idle_gaps"]:
        head = name.split("/")[0]
        sums[head] = sums.get(head, 0.0) + t
    assert sums == pytest.approx(dict(today["idle_gaps"]))
    for key in ("busy_s", "window_s", "by_op", "device_ops"):
        assert new[key] == today[key], key


def test_span_busy_owns_launches_and_clips_to_the_window():
    s = spans.summarise(serving_events(), PROGRAM)
    assert s["span_busy"] == pytest.approx({
        "step.prefill": (220 + 130 + 140 + 50 + 100) * 1e-6,
        "lm.attention": 220e-6,
        "lm.moe": (130 + 140 + 50 + 100) * 1e-6,            # k6 clipped
        "moe.experts": 140e-6})
    assert s["unlaunched_s"] == 0
    assert "lm.moe" not in s["by_op"]          # a span's copy: no operation


def test_backward_thread_launches_go_to_spans_on_any_thread():
    events = [ev("window", "CPU", 0, 500), ev("step call", "CPU", 0, 500),
              ev("step.train", "CPU", 0, 500),
              ev("train.backward", "CPU", 100, 400),
              ev("cudaLaunchKernel", "CPU", 150, 152, thread=2, cid=9),
              ev("k9", "CUDA", 160, 260, cid=9),
              ev("k0", "CUDA", 300, 320, cid=77)]     # no launch in the trace
    s = spans.summarise(events, PROGRAM)
    assert s["span_busy"] == pytest.approx({"step.train": 100e-6,
                                            "train.backward": 100e-6})
    assert s["unlaunched_s"] == pytest.approx(20e-6)


def test_sync_idle_counts_only_calls_inside_a_step():
    events = [ev("window", "CPU", 0, 300), ev("step call", "CPU", 0, 100),
              ev("step.prefill", "CPU", 0, 100),
              ev("cudaStreamSynchronize", "CPU", 20, 80),
              ev("greedy pick", "CPU", 100, 300),
              ev("lm.moe", "CPU", 120, 290),     # a span outside any step
              ev("cudaStreamSynchronize", "CPU", 150, 250),
              ev("k", "CUDA", 95, 110)]
    s = spans.summarise(events, PROGRAM)
    assert s["sync_idle_s"] == pytest.approx(95e-6)
    assert dict(s["idle_gaps"]) == pytest.approx({
        "step call/step.prefill/cudaStreamSynchronize": 95e-6,
        "greedy pick/lm.moe/cudaStreamSynchronize": 190e-6})


def test_readings_per_unit_and_none_without_device_events():
    s = spans.summarise(serving_events(), PROGRAM)
    r = spans.readings(s, "prefill", 2)
    assert set(r) == {"attention_ms.prefill", "moe_ms.prefill",
                      "idle_in_sync.prefill"}
    assert r["moe_ms.prefill"]["value"] == pytest.approx(420e-3 / 2)
    assert r["moe_ms.prefill"]["busy_share"] == pytest.approx(
        100 * 420 / s["busy_s"] / 1e6)
    assert r["idle_in_sync.prefill"]["value"] == pytest.approx(11.0)
    assert r["idle_in_sync.prefill"]["calls_per_unit"] == {
        "lm.moe": {"cudaStreamSynchronize": 0.5}}
    cpu_only = [e for e in serving_events() if e.device_type.name == "CPU"]
    assert spans.readings(spans.summarise(cpu_only, PROGRAM), "prefill",
                          2) == {}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "t_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def counters():
    from repro_torch import obs
    obs.reset()
    yield obs
    obs.enable(False)
    obs.reset()


def test_expert_fill_readers_on_counters(counters):
    obs = counters
    read = _reader("expert_fill.decode")
    assert read({"kind": "decode"}) is None             # nothing counted
    obs.enable(True)
    obs.add("moe.dispatched", 256)
    obs.add("moe.kept", torch.tensor(200))
    obs.add("moe.slots", 8192)
    assert read({"kind": "prefill"}) is None
    got = read({"kind": "decode"})
    assert got["value"] == pytest.approx(100 * 200 / 8192)
    assert got["dropped"] == pytest.approx(100 * 56 / 256)
    assert read({"kind": "decode"}) is None             # read once


@pytest.mark.parametrize("workload,metric", [
    ("qwen3moe-l4.prefill-mix", "expert_fill.prefill"),
    ("qwen3moe-l4.decode-b32", "expert_fill.decode")])
def test_traced_cpu_rehearsal_reports_expert_fill(counters, workload,
                                                  metric):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = run_cell(small_ctx(workload, 7, trace=True))
    finally:
        torch.set_num_threads(n)
    m = out["metrics"][metric]
    assert out["correct"] and m["unit"] == "%"
    assert 0 < m["value"] <= 100 and m["kept"] <= m["dispatched"]
    assert m["value"] == pytest.approx(100 * m["kept"] / m["slots"])
