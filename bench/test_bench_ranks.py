"""The rank launcher (``bench/ranks.py``) and the cell of four cards on the
CPU: ``gloo`` ranks, one torch thread each, every launch under a deadline
that ends its ranks.  A four-rank rehearsal of
``qwen3moe-l16-tp4.prefill-mix`` at its files' ``test_sizes`` (``correct``
true, the float8 control not; one rank's experts' partial left out of the
combine, and the serving faults of ``test_bench_cells``, caught), a rank
that raises mid-window, the mesh-drawn weights against the one-card tree's
slices, the layer-major reference and the tallies split over ranks against
one rank's, and the one-card path, which spawns nothing."""
from __future__ import annotations

import argparse
import multiprocessing
import time
from unittest import mock

import pytest
import torch

from bench import calibrate, check, harness, program, ranks, serve
from bench.reference import qwen3_moe
from bench.harness import run_cell
from bench.small import small_ctx

TP4, PREFILL = "qwen3moe-l16-tp4.prefill-mix", "qwen3moe-l4.prefill-mix"
SEEDS = (3, 2**31 + 17)
DEADLINE = 240


def _payload(**kw):
    return {"workload": TP4, "seeds": list(SEEDS), "seconds": 0.2,
            "control": False, "fault": None, "small": True, "out": None,
            **kw}


def _no_children():
    for p in multiprocessing.active_children():
        p.join(5)
    return not multiprocessing.active_children()


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_four_card_rehearsal_is_correct_and_its_control_is_not():
    recs = ranks.launch(4, "cpu", calibrate.readings,
                        _payload(control=True), deadline=DEADLINE)
    limits = small_ctx(TP4, 0).limits
    assert [r["seed"] for r in recs] == list(SEEDS)
    for r in recs:
        ok, checks = check.verdict(r["program"], limits)
        assert ok, checks
        assert not check.verdict(r["control"], limits)[0], r["control"]
    assert _no_children()


def test_one_ranks_partial_left_out_of_the_combine_is_caught():
    recs = ranks.launch(4, "cpu", calibrate.readings,
                        _payload(fault="rank_partial"), deadline=DEADLINE)
    for r in recs:
        assert not r["correct"], r["fault_rank_partial"]


def test_traced_four_card_rehearsal_reports_its_layers():
    recs = ranks.launch(4, "cpu", calibrate.readings,
                        _payload(seeds=[5], trace=True), deadline=DEADLINE)
    assert recs[0]["correct"], recs[0]["program"]
    # on the CPU no NCCL kernel ran: the collective share reads nothing
    assert "collective_share.prefill" not in recs[0]["metrics"]
    assert "device_idle.prefill" in recs[0]["metrics"]


def _raising(rank, world, dev, host, p):
    """``calibrate.readings`` with rank 1's prefill raising at the window's
    third batch (after the warm-up's three shapes)."""
    from repro_torch.train import step as step_mod
    whole, calls = step_mod.prefill, [0]

    def broken(*args, **kw):
        calls[0] += 1
        if rank == 1 and calls[0] == 6:
            raise RuntimeError("a rank fails mid-window")
        return whole(*args, **kw)
    with mock.patch.object(step_mod, "prefill", broken):
        return calibrate.readings(rank, world, dev, host, p)


def test_a_rank_that_raises_ends_the_run_without_a_result():
    t = time.monotonic()
    with pytest.raises(ranks.RankFailure, match="rank 1"):
        ranks.launch(4, "cpu", _raising, _payload(seeds=[7]),
                     deadline=DEADLINE)
    assert time.monotonic() - t < DEADLINE
    assert _no_children()


def test_a_run_past_its_deadline_is_ended():
    with pytest.raises(ranks.RankFailure, match="deadline"):
        ranks.launch(2, "cpu", calibrate.readings, _payload(seeds=[7]),
                     deadline=1)
    assert _no_children()


def _shards_and_slices(rank, world, dev, host, p):
    """Every leaf's mesh-drawn shard against ``shard_params`` of the
    one-card tree, on this rank."""
    from repro_torch.models.params import shard_params
    ctx = small_ctx(TP4, p["seeds"][0])
    rules = harness.mesh_rules(ctx.conf, "cpu")
    cfg = program.port_config(ctx.conf)
    shapes = qwen3_moe.leaf_shapes(qwen3_moe.spec(ctx.conf))
    drawn = program.port_params(cfg, ctx.conf, shapes, ctx.seed, dev, rules)
    whole = shard_params(program.port_params(cfg, ctx.conf, shapes,
                                             ctx.seed, dev), cfg, rules)
    out = []
    for (path, a), (_, b) in zip(program._walk(drawn), program._walk(whole)):
        out.append((path, tuple(a.shape) == tuple(b.shape)
                    and a.placements == b.placements
                    and torch.equal(a.to_local(), b.to_local()),
                    a.to_local().numel() < a.numel()))
    return out


def test_mesh_drawn_shards_equal_the_one_card_trees_slices():
    got = ranks.launch(4, "cpu", _shards_and_slices, _payload(),
                       deadline=DEADLINE)
    assert got and all(same for _, same, _ in got), got
    split = {path[-1] for path, _, part in got if part}
    assert {"embed", "lm_head", "w_router", "w_gate", "w_up",
            "w_down"} <= split


def test_layer_major_reference_equals_forward_bit_for_bit():
    ctx = small_ctx(PREFILL, 11)
    ref = qwen3_moe
    s = ref.spec(ctx.conf)
    w = check.Weights(ctx.conf["run"]["init"], ref.leaf_shapes(s), 11,
                      ctx.device, s.layers)
    g = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, s.vocab, shape, generator=g)
               for shape in ((4, 32), (2, 64), (1, 128))]
    for quant in (ref.exact, ref.fp8):
        kv = [[] for _ in batches]
        hs = ref.forward_batches(s, w, batches, quant=quant, kv=kv,
                                 done=w.drop)
        for tokens, h, kvs in zip(batches, hs, kv):
            want_kv = []
            want = ref.forward(s, w, tokens, quant=quant, kv=want_kv)
            assert torch.equal(h, want)
            for (k, v), (kw, vw) in zip(kvs, want_kv):
                assert torch.equal(k, kw) and torch.equal(v, vw)


def _split_tallies(rank, world, dev, host, p):
    """One-card kept batches, their numbers from this rank alone and from
    the four ranks' split (every rank ran the same program alike)."""
    ctx = small_ctx(PREFILL, p["seeds"][0], 0.1)
    ctx.cfg, ctx.ref = program.port_config(ctx.conf), qwen3_moe
    ctx.spec = ctx.ref.spec(ctx.conf)
    ctx.ref_shapes = ctx.ref.leaf_shapes(ctx.spec)
    kept = serve.prefill(ctx).kept
    one = check.serving_numbers(ctx, kept, control=True)[0]
    ctx.rank, ctx.world, ctx.host = rank, world, host
    split = check.serving_numbers(ctx, kept, control=True)[0]
    return one, split


def test_tallies_split_over_ranks_equal_one_ranks():
    one, split = ranks.launch(4, "cpu", _split_tallies, _payload(),
                              deadline=DEADLINE)
    assert one == split


def test_cell_runs_on_as_many_ranks_as_it_has_cards():
    """A cell of four cards never runs on one process and reports 4."""
    with pytest.raises(SystemExit, match="4 cards"):
        run_cell(small_ctx(TP4, SEEDS[0]))


def _args(workload):
    return argparse.Namespace(workload=workload, seed=1, seconds=0.1,
                              trace=0)


def test_four_card_cell_on_fewer_cards_exits_2(capsys):
    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.device_count", return_value=1), \
            mock.patch.object(ranks, "launch",
                              side_effect=AssertionError("spawned")):
        assert harness.main(_args(TP4), time.perf_counter()) == 2
    assert '"correct"' not in capsys.readouterr().out


def test_one_card_cell_spawns_nothing_and_joins_no_group(capsys):
    import torch.distributed as dist
    seen = []

    def here(ctx, **kw):
        seen.append(ctx)
        return run_cell(small_ctx(PREFILL, 1, 0.1))
    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.device_count", return_value=4), \
            mock.patch("torch.cuda.get_device_name", return_value="cpu"), \
            mock.patch("torch.cuda.set_device"), \
            mock.patch.object(harness, "run_cell", here), \
            mock.patch.object(harness, "_power_limit_w", return_value=None), \
            mock.patch.object(ranks, "launch",
                              side_effect=AssertionError("spawned")), \
            mock.patch.object(dist, "init_process_group",
                              side_effect=AssertionError("joined")):
        assert harness.main(_args(PREFILL), time.perf_counter()) == 0
    assert len(seen) == 1 and seen[0].world == 1 and seen[0].rules is None
    assert not dist.is_initialized()
    assert '"correct": true' in capsys.readouterr().out.splitlines()[-1]
    assert not multiprocessing.active_children()


def _serving_fault(rank, world, dev, host, p):
    """``calibrate.readings`` under one of the serving faults of
    ``test_bench_cells`` (the same patch of the port's ``prefill``, which
    the sharded step calls on each rank's part)."""
    from bench.test_bench_cells import _serving_fault as fault
    with fault("prefill", p["serving_fault"]):
        return calibrate.readings(rank, world, dev, host, p)


@pytest.mark.parametrize("fault", ["unchanged", "half", "token"])
def test_four_card_serving_fault_is_caught(fault):
    recs = ranks.launch(4, "cpu", _serving_fault,
                        _payload(seeds=[SEEDS[0]], serving_fault=fault),
                        deadline=DEADLINE)
    assert not recs[0]["correct"], (fault, recs[0]["program"])
