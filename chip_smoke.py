#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build the CUDA kernels,
drive the single-tree and forest paths at Give Me Some Credit scale, hold
each kernel against its plain PyTorch version, serve requests, run the LM
serving path at qwen3-moe-235b-a22b's width and at the widths of rwkv6,
whisper and jamba, train olmo-1b at its full width and depth, unsharded and
data-parallel on a mesh of one card, and print what was measured.

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and power
   limit;
2. set-up: ``nvcc`` builds both kernels from ``src/repro_torch/csrc`` into
   ``build/kernels`` (timed);
3. main path: fit CART on credit (108,242 train rows, 10 features) at the
   benchmark fit parameters, compile at S=128 (8576 x 4992 cells), run
   ``tcam_infer`` on all 12,027 test queries with engines auto (= packed),
   mxu and ref: predictions equal the tree's own, one survivor each, all
   SimResult fields equal across engines.  Then stuck faults and SA offsets
   through ``DT2CAM.infer`` (auto = mxu, equal to ref), and the covid
   dataset through ``DT2CAM.fit(...).infer(backend="torch")`` against the
   numpy oracle.  The kernels' launch counters are zeroed before this phase
   and read after it: both kernels ran through their prepacked entries
   only, on the tiled path, each launch after one word pack on the card;
4. kernels at the credit shapes (B=12027, R=8576, W=4992, S=128, D=39), with
   an SA-variability kmax holding -1, 0 and >0: kernel == plain version
   (``torch.equal``), then CUDA-event medians of the kernel, the plain
   version and a PyTorch yardstick, beside the least time the card could
   take: the largest of the bytes over the card's memory rate and each
   pipe's operations (LOP3 and popcount, counted from this run's evals)
   over its rate on this card.  Both kernels are timed as the main path
   calls them: the prepacked entry (the pack kernel on the search words,
   then the match) on operands from ``prepare_match``; the other entry
   (uint8 planes, row-major packed words) is held against it.  Each record
   adds evaluated triples per second, output GB/s, the pack kernel's time
   and its ``torch.equal`` against ``pack_bits``, the one-off operand pack
   at prepare, the match alone and on division 0 only, the time the card
   takes to write arrays of the outputs' size (the store floor), and
   ``ptxas``'s registers, shared memory and spills.  The packed row adds
   the same call at kmax = 0 (the main path's operands), held against the
   plain version and timed;
5. serving: ``TCAMServer`` on credit, warmed up, serving 4096 test queries;
   results equal ``tcam_infer``'s, through the packed kernel's prepacked
   entry;
6. forest: fit the credit forest (``train_forest`` defaults: 25 bagged
   trees at ``max_depth=12``, seed 0), compile at S=128 and plan it (two
   groups).  Main path: ``ForestExecutor(engine="mxu")`` on all 12,027 test
   queries, the banked kernel's counters zeroed before and read after (one
   launch per group, each on the tiled path): predictions equal the trees' hard vote, one survivor
   per bank and query; engines banked and ref give the same ``ForestResult``
   on a slice.  Then the banked kernel at both group shapes against its
   plain version (an SA kmax holding -1, 0 and >0; stuck faults in the first
   group), through the prepacked entry on ``prepare_banked`` operands with
   the same added figures as phase 4, timed beside a bf16 ``torch.bmm``
   yardstick and its bound; then
   forest serving of 4096 queries with engines mxu and auto (= mxu on the
   card), equal to the executor, each launching the banked kernel;
7. chip health and model lifecycle at credit width (``health_phase``), with
   the kernels' counters zeroed before and read after (the bitplane, packed
   and banked kernels each launched): serving with a canary after every
   batch; BIST on the card on a faulted 8832-row layout (256 spare rows)
   held against the plain per-row loop on a sample of rows, repair, a
   clean re-test, and serving equal to ``tcam_infer`` on the repaired
   grid with survivors on spare rows; the circuit breaker's ladder on a
   chip whose canary trips, with the launches of every batch before the
   rung it reached; ``row_utilization`` over the training inputs through
   the kernel, held against its plain version; per-bank BIST and repair
   of the credit forest served on mxu and equal to a banked server;
   ``ReplicatedServer`` with three chips; and the lifecycle: a delta plan
   to a candidate tree of half the leaves with its write figures and wear,
   stage / mirror / promote / rollback each serving equal to
   ``tcam_infer``, and a registry round trip of both models;
8. drift, margins and scrub at credit width (``drift_phase``), with the
   kernels' counters zeroed before and read after (the bitplane and packed
   kernels each launched): a drifting credit server (engine auto) serves
   fresh, equal to ``tcam_infer``; an accelerated-aging sweep logs per age
   the rows with negative margins, the rows due, the engine ``auto``
   resolved to (``mxu`` once drift put ``CELL_MM`` in the grid) and the
   accuracy against the tree; at one age the served grid equals the
   copied numpy readout over every cell and the margins the numpy loop's;
   at the first age with rows due a margin scrub (margins, plan and
   refresh timed apart) and serving equal to the plain version, then a
   forced scrub after which serving equals the fresh answers; serving with
   a periodic scrub after every batch; a breaker tripped by an aged chip
   that recovers on the scrub rung without a repair; host-vs-card times of
   the readout and the margins;
9. the LM serving path at full width (``lm_phase``), with the kernels'
   counters zeroed before and read after (this path launches none of the
   match kernels): ``qwen3_moe_235b_a22b`` at every published width, cut
   from 94 to ``LM_LAYERS`` = 4 layers, the earlier phases' device memory
   freed first; ``init_params`` on the card (count, bytes, peak memory);
   ``prefill`` of 256 tokens then ``decode_step`` of one against
   ``forward`` at capacity factor 16, in f32 compute (every token routed
   alike, logits within 5e-2) and in bf16 as served (within 5e-2 where
   every layer routed alike; elsewhere the experts may differ only at a
   near tie of the gates, which bf16 rounding flips); a prefill of 8 x 2048
   ``make_batch`` tokens and 32 greedy decode steps timed with CUDA
   events, all logits finite, beside their bounds (bytes over the memory
   rate, bf16 and f32 operations over their peak rates); one MoE layer on
   64 f32 tokens against the dense per-expert computation; layer 0's
   softmax router distilled into a CART tree on 64 columns of the
   prefill's normed hidden states, compiled by ``compile_router`` and
   routed by ``route_tcam`` on the card, equal to the tree on every
   token, and ``moe_ffn(router="tcam_dt")`` at full width;
10. the recurrent and encoder-decoder families at full width
   (``lm_families_phase``), with the kernels' counters zeroed before and
   read after (none launched): ``rwkv6_1p6b`` (all 24 layers),
   ``whisper_small`` (12 encoder + 12 decoder layers, 1500 frames) and
   ``jamba_v01_52b`` (8 of 32 layers: one whole Jamba block), one at a
   time, each freed before the next.  For each: ``init_params`` on the
   card (count against the config's, bytes, peak memory); prefill of
   2 x 256 tokens then one decode step against ``forward`` over 257, in
   f32 compute and in bf16 as served, within 5e-2 (jamba at capacity
   factor 16 with ``forward``'s experts replayed, every token routed
   alike in f32); layer 0's chunked mixer against the token recurrence
   over 2·CHUNK tokens at full width (mamba 2e-3, rwkv 5e-3); a prefill
   of 8 x 2048 tokens (whisper: 8 x 448, its text context, after encoding
   8 x 1500 frames) and 32 greedy decode steps timed with CUDA events,
   all logits finite and every cache written, beside their bounds;
11. training (``train_phase``), with the kernels' counters zeroed before
   and read after (none launched): ``olmo_1b`` whole (16 layers, every
   published width, 1.18 B params).  Checks first, on 2 of its 16 layers
   at full width and 2 x 128 tokens: ``loss_fn``'s loss and every
   gradient leaf on the card against the CPU in f32 compute, and one
   ``adamw_update`` on the same gradients; remat ``none``/``dots``/
   ``full`` alike; accum 2 against accum 1; a checkpoint saved at step 3
   and restored into a fresh state gives step 4 bit for bit (under
   PyTorch's deterministic algorithms); ``FaultTolerantLoop`` with a
   failure injected at its 7th call reaches step 12 after restoring step
   5; one compressed step (``q`` within +-127, finite residual and loss).
   Then the main cell: ``TokenPipeline(cfg, 8, 2048)``, ``remat="full"``,
   AdamW defaults with a 5-step warm-up over 30: 2 warm-up steps and 5
   steps timed with CUDA events, tokens/s, peak memory, the update alone,
   the step's bound (``train_work``), and ``loss_fn`` against the
   cross-entropy of ``forward``'s logits; 30 steps at 8 x 512 from a fresh
   state, whose loss falls by more than ``TRAIN_DECREASE_MARGIN``; one
   timed step each of ``rwkv6_1p6b`` (8 x 512) and ``whisper_small``
   (8 x 448 after 8 x 1500 frames), whole;
12. sharding (``sharding_phase``), with the kernels' counters zeroed
   before and read after (none launched): the per-device train state of
   the ``train_4k`` cell of ``olmo_1b`` and ``qwen3_moe_235b_a22b`` on the
   (16, 16) and (2, 16, 16) production meshes, from ``input_specs``; an
   NCCL process group of one (a ``FileStore`` in a temporary directory),
   ``mesh_for_devices(1)`` and ``make_rules(mesh, dp_only=True)``; olmo-1b
   whole at phase 11's 8 x 2048, remat and AdamW config: 2 unsharded steps
   and 2 sharded steps from the same seed, every param, ``mu`` and ``nu``
   leaf and the losses equal bit for bit (deterministic algorithms on);
   2 warm-up and 5 sharded steps timed with CUDA events, tokens/s and peak
   memory beside phase 11's, the bound from ``train_work``; a checkpoint
   of the sharded state restored with ``restore_resharded`` onto the mesh
   gives the next step bit for bit; the dry run of ``olmo_1b`` x
   ``train_4k`` (``launch.dryrun.run_cell``), its per-device FLOPs within
   ``SHARD_FLOPS_TOL`` of ``sharded_step_flops`` and their ratio to
   ``train_work``'s reference count;
13. the kernels line, the card's name and power limit, and the last line:
   ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Peak memory rate by card (NVIDIA data sheets), bytes/s; the name decides.
PEAK_BW = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
           ("H100", 3.35e12))
# Results per clock per SM of the pipes the match kernels issue on, for
# compute capability 9.0 (NVIDIA CUDA C++ Programming Guide, throughput of
# native arithmetic instructions): 32-bit bitwise logic (LOP3) 64, 32-bit
# population count 16.  Times the card's SM count and maximum SM clock.
PIPE_PER_CLOCK_PER_SM = {"logic": 64, "popc": 16}
SERVE_REQUESTS = 4096
FOREST_DATASET = "credit"    # the forest phase: train_forest's defaults here,
FOREST_TREES = 25            # 25 bagged trees at max_depth=12, seed 0,
FOREST_S = 128               # compiled at S=128
FOREST_SLICE = 512           # queries checked on the banked and ref engines
# phase 7: chip health and lifecycle at credit width
HEALTH_SPARES = 256          # compile_tree(spare_rows=): 8832 x 4992 cells
HEALTH_P = 3e-6              # p_sa0 = p_sa1: the spares suffice
BREAKER_P = 1e-5             # the spares run out
BREAKER_THRESHOLD = 0.99     # canary accuracy to hold: one miss in 32 trips
BREAKER_SEEDS = range(6)     # first seed whose first canary trips
FOREST_HEALTH_P = 5e-7       # flags rows in several of the forest's banks
BIST_REF_ROWS = 128          # rows held against the plain per-row BIST
UTIL_REF_INPUTS = 256        # inputs held against the plain row_utilization
UTIL_REF_CHUNK = 64          # inputs per host thread's plain call
HOST_THREADS = 8             # phase 7's host set-up and plain versions
REPLICAS = 3
# phase 8: drift, margins and scrub at credit width
DRIFT_LAW = dict(nu=0.05, nu_sigma=0.02, retention_tau_s=2e6)
DRIFT_SEED = 0
# margin policy threshold: the default 0.15 V lies above S=128's design
# margin (0.1145 V), so it would flag every row of a fresh credit chip;
# 0.05 V refreshes a row once it has lost more than half of it
DRIFT_MARGIN_V = 0.05
DRIFT_AGES = (1e3, 1e4, 1e5, 1e6, 3e7)   # virtual seconds since the start
DRIFT_REF_AGE = 3e7          # age held against the copied numpy bodies
DRIFT_PLAIN_QUERIES = 256    # served queries held against the plain match
DRIFT_SCRUB_REQUESTS = 2048  # served with a periodic scrub after every batch
DRIFT_BATCH_S = 2.5e5        # virtual seconds per batch there
DRIFT_PERIOD_S = 1e6         # periodic policy: a full refresh every 4 batches
DRIFT_TRIP_REQUESTS = 512
LM_ARCH = "qwen3_moe_235b_a22b"   # the LM phase: every published width,
LM_LAYERS = 4                # 94 layers cut to 4: f32 weights of 44.8 GB
LM_BATCH = 8                 # timed prefill of LM_BATCH x LM_PROMPT tokens,
LM_PROMPT = 2048             # then LM_DECODE greedy decode steps
LM_DECODE = 32
LM_SEED = 0
LM_CHECK_BATCH = 2           # prefill of LM_CHECK_SEQ tokens, then decode of
LM_CHECK_SEQ = 256           # one, against forward over LM_CHECK_SEQ + 1 at
LM_CHECK_CF = 16.0           # capacity factor 16 (as the JAX package's test)
LM_CHECK_TOL = 5e-2          # rtol = atol on bf16 logits (the same test's)
LM_MOE_TOKENS = 64           # f32 tokens through one MoE layer, held against
LM_MOE_TOL = 2e-4            # the dense per-expert computation (test_models)
LM_ROUTER_FEATURES = 64      # hidden-state columns the CART router sees: the
LM_ROUTER_DEPTH = 10         # fit loops over features on the host
LM_ROUTER_LEAVES = 256
# phase 10: the recurrent and encoder-decoder families, every published
# width; arch -> (layers, None for all; prompt tokens of the timed prefill)
LM_FAMILIES = {
    "rwkv6_1p6b": (None, 2048),
    "whisper_small": (None, 448),      # Whisper's published text context
    "jamba_v01_52b": (8, 2048),        # one whole Jamba block of 8 layers
}
LM_STEP_TOL = {"mamba": 2e-3, "rwkv": 5e-3}   # chunked vs stepwise (the
                                              # JAX package's test_models)
# phase 11: training, olmo-1b whole (16 layers, every published width)
TRAIN_ARCH = "olmo_1b"
TRAIN_BATCH = 8              # timed steps of TRAIN_BATCH x TRAIN_SEQ tokens:
TRAIN_SEQ = 2048             # 16,384 tokens a step
TRAIN_WARMUP = 2             # untimed steps, then TRAIN_TIMED timed ones
TRAIN_TIMED = 5
TRAIN_OPT = dict(warmup_steps=5, total_steps=30)   # AdamWConfig otherwise
TRAIN_REMAT = "full"
TRAIN_CUT_LAYERS = 2         # the checks at full width, 2 of 16 layers, on
TRAIN_CUT_BATCH = 2          # TRAIN_CUT_BATCH x TRAIN_CUT_SEQ tokens
TRAIN_CUT_SEQ = 128
TRAIN_DECREASE_STEPS = 30    # the loss decreases over these steps of the
TRAIN_DECREASE_SEQ = 512     # planted-structure stream at 8 x 512
TRAIN_FAMILIES = {"rwkv6_1p6b": 512,       # one timed step each, whole, at
                  "whisper_small": 448}    # 8 x this (whisper: text context)
# phase 12: sharding, olmo-1b whole on a mesh of one card (TRAIN_* sizes)
SHARD_STEPS = 2              # unsharded, then sharded steps from one seed,
SHARD_FLOPS_TOL = 0.02       # the dry run's FLOPs against sharded_step_flops
SHARD_STATE_ARCHS = ("olmo_1b", "qwen3_moe_235b_a22b")
# Tolerances of phase 11 (fixed before its first run on the card):
TRAIN_LOSS_RTOL = 1e-5       # loss, card vs CPU (f32 compute)
TRAIN_GRAD_TOL = 1e-4        # grad leaves, card vs CPU and accum 2 vs 1 (f32),
                             # as a fraction of the leaf's largest |g|
TRAIN_REMAT_TOL = 1e-5       # remat none / dots / full on the card, the same
TRAIN_UPDATE_TOL = dict(rtol=1e-6, atol=1e-9)   # one adamw_update, card vs
                                                # CPU on the same grads
TRAIN_LOGITS_RTOL = 1e-4     # loss_fn vs the CE of forward's bf16 logits
TRAIN_DECREASE_MARGIN = 0.1  # mean of the last 5 losses below the first 5 by
                             # more than this (tools/train_probe.py --lrs on its
                             # seed fell 0.183 at the default lr; PERF.md §6)
# Dense peak rates by card (NVIDIA data sheets, no sparsity), operations/s:
# bf16 on the tensor cores, f32 outside them.  The name decides.
PEAK_FLOPS = (("H200", 989e12, 67e12), ("H100 NVL", 835e12, 60e12),
              ("H100 PCIe", 756e12, 51e12), ("H100", 989e12, 67e12))
REPLACES = {"tcam_match": "src/repro/kernels/tcam_match.py:38",
            "tcam_packed": "src/repro/kernels/tcam_packed.py:30",
            "tcam_match_banked": "src/repro/kernels/banked.py:147"}
PTXAS: dict = {}             # kernel (mangled name) -> ptxas -v report, phase 2
SOURCES = {"tcam_match": "src/repro_torch/csrc/tcam_match.cu",
           "tcam_packed": "src/repro_torch/csrc/tcam_packed.cu",
           "tcam_match_banked": "src/repro_torch/csrc/tcam_match.cu"}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bw(name: str) -> float:
    for key, bw in PEAK_BW:
        if key in name:
            return bw
    raise RuntimeError(f"no memory-rate entry for card {name!r}")


def same_result(a, b, what: str, skip: tuple = ()) -> None:
    import dataclasses

    import numpy as np
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        ok = np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        check(bool(ok), f"{what}: {type(a).__name__}.{f.name} differs")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pipe_rates() -> dict:
    """Operations per second of each pipe in ``PIPE_PER_CLOCK_PER_SM`` on
    this card: the SM count from PyTorch, the maximum SM clock from
    nvidia-smi."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0]
    clock = float(mhz) * 1e6
    log(f"pipes: {sms} SMs at {clock / 1e9:.3f} GHz: " + ", ".join(
        f"{k} {n * sms * clock / 1e12:.2f} T/s"
        for k, n in PIPE_PER_CLOCK_PER_SM.items()))
    return {k: n * sms * clock for k, n in PIPE_PER_CLOCK_PER_SM.items()}


def bitplane_ops(evals, s: int) -> dict:
    """The bitplane kernel's operations: per evaluated triple one LOP3 and
    one popcount per word of the division."""
    import torch
    n = int(evals.sum(dtype=torch.int64)) * -(-s // 32)
    return {"logic": n, "popc": n}


def packed_ops(evals, kmax_t, s: int) -> dict:
    """The packed kernel's operations: per evaluated triple one LOP3 per
    word; popcounts only for triples whose division has kmax > 0, counted
    on the card from evals and a per-row prefix count of kmax > 0."""
    import torch
    sw = s // 32
    pos = (kmax_t > 0).to(torch.int64)                    # (D, R)
    prefix = torch.cat((torch.zeros_like(pos[:1]), pos.cumsum(0)))
    popc = torch.gather(prefix, 0, evals.long()).sum()    # (B, R) -> scalar
    return {"logic": int(evals.sum(dtype=torch.int64)) * sw,
            "popc": int(popc) * sw}


def measure(kname: str, cases: list, launches: int, bw: float,
            rates: dict) -> dict:
    """Hold a kernel against its plain version (``torch.equal``) and time
    both, with a PyTorch yardstick, at each of ``cases``: dicts with ``run``,
    ``plain``, ``library`` (or None), ``inputs``, ``ops(got)`` (operations
    by pipe of ``rates``) and ``shape``.  Times, bytes and bounds add up
    over the cases (the launches one pass of the main path makes);
    ``bound_ms`` is the largest of bytes over the memory rate and each
    pipe's operations over its rate.  A case's optional ``extra(got)``
    adds figures to its record."""
    import torch
    rec = {"name": kname, "route": "cuda", "source": SOURCES[kname],
           "replaces": REPLACES[kname], "launches": launches,
           "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes", "library_ms": None, "bytes": 0,
           "output_bytes": 0, "operations": {k: 0 for k in rates},
           "evaluated_divisions": 0, "cases": []}
    for case in cases:
        run, plain = case["run"], case["plain"]
        got = run()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"{kname} {case['shape']}: kernel == "
                  "plain version")
        rec["max_abs_err"] = max(
            [rec["max_abs_err"]]
            + [float((g - w).abs().max()) for g, w in zip(got, want)])
        del want
        evals_total = int(got[1].sum(dtype=torch.int64))
        out_bytes = sum(t.numel() * t.element_size() for t in got)
        nbytes = out_bytes + sum(t.numel() * t.element_size()
                                 for t in case["inputs"])
        ops = case["ops"](got)
        extra = case["extra"](got) if case.get("extra") else {}
        del got
        terms = {"bytes": nbytes / bw * 1e3}
        terms.update({k: n / rates[k] * 1e3 for k, n in ops.items()})
        one = {"shape": case["shape"], "ms": cuda_ms(run, reps=10, warmup=2),
               "plain_ms": cuda_ms(plain, reps=3),
               "library_ms": (None if case["library"] is None
                              else cuda_ms(case["library"], 10, 2)),
               "bound_ms": max(terms.values()), "bound_terms_ms": terms,
               "bytes": nbytes, "operations": ops,
               "evaluated_divisions": evals_total}
        one["triples_per_s"] = evals_total / one["ms"] * 1e3
        one["output_GBps"] = out_bytes / one["ms"] * 1e-6
        one.update(extra)
        one["output_bytes"] = out_bytes
        for k in ("ms", "plain_ms", "bytes", "output_bytes",
                  "evaluated_divisions"):
            rec[k] += one[k]
        for k, n in ops.items():
            rec["operations"][k] += n
        if one["library_ms"] is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + one["library_ms"]
        rec["cases"].append(one)
    terms = {"bytes": rec["bytes"] / bw * 1e3}
    terms.update({k: n / rates[k] * 1e3 for k, n in rec["operations"].items()})
    rec["bound_ms"] = max(terms.values())
    rec["bound_terms_ms"] = terms
    rec["bound_by"] = ("bytes" if terms["bytes"] >= rec["bound_ms"]
                       else "operations")
    rec["triples_per_s"] = rec["evaluated_divisions"] / rec["ms"] * 1e3
    rec["output_GBps"] = rec["output_bytes"] / rec["ms"] * 1e-6
    if len(cases) == 1:
        one = rec.pop("cases")[0]
        rec.update({k: v for k, v in one.items() if k not in rec})
    log(json.dumps(rec))
    return rec


def kernel_counters() -> dict:
    """Every kernel wrapper that counts its launches, by name."""
    from repro_torch import kernels as tk
    return {f.__name__: f for f in (
        tk.tcam_match_cuda, tk.tcam_match_bits_cuda, tk.tcam_match_packed_cuda,
        tk.tcam_match_packed_bits_cuda, tk.tcam_match_banked_cuda,
        tk.tcam_match_banked_bits_cuda, tk.pack_words_cuda,
        tk.pack_planes_cuda)}


def path_counters() -> dict:
    """The bitplane (``path_*``) and packed (``packed_path_*``) kernels'
    launches by path."""
    from repro_torch.kernels import MATCH_PATH_LAUNCHES, PACKED_PATH_LAUNCHES
    return {"path": MATCH_PATH_LAUNCHES, "packed_path": PACKED_PATH_LAUNCHES}


def zero_counts() -> None:
    for f in kernel_counters().values():
        f.launches = 0
    for paths in path_counters().values():
        for path in paths:
            paths[path] = 0


def read_counts() -> dict:
    """Launches per wrapper, and each match kernel's by path."""
    counts = {n: f.launches for n, f in kernel_counters().items()}
    for prefix, paths in path_counters().items():
        counts.update({f"{prefix}_{k}": v for k, v in paths.items()})
    return counts


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def record_ptxas(reports: dict) -> None:
    """Keep ``build_all()``'s ``ptxas -v`` lines (registers, shared memory,
    spills) in ``PTXAS`` by kernel, and log them."""
    for src, out in reports.items():
        entry = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("registers" in line or "spill" in line):
                PTXAS[entry] = (PTXAS.get(entry, "") + " "
                                + line.split(":", 1)[-1].strip()).strip()
                log(f"  ptxas {src}: {line.strip()}")


def ptxas_of(fragment: str) -> str:
    """``ptxas -v``'s report (registers, shared memory, spills) of the
    kernel whose mangled name holds ``fragment``, from phase 2's build."""
    lines = [v for k, v in PTXAS.items() if fragment in k]
    return lines[0] if lines else "not reported: library built before this run"


def match_extra(got, x, p0, p1, words, kmax_t, s: int, other_entry, launch,
                kernel: str) -> dict:
    """Figures the match rows add (phases 4 and 6), on G-leading tensors:
    the kernel's other entry (``other_entry()``: uint8 planes, or row-major
    packed words) equals the prepacked one; the pack kernel on the search
    words equals ``pack_bits`` (``torch.equal``), and its time; the one-off
    pack of the operands from planes ``p0``, ``p1`` at ``prepare_*``,
    equal to the operands it made (``words``), and its time; the match
    kernel alone on packed words (``launch(xw, words, kmax_t, b, s)``),
    and on division 0 only (the same launch with D = 1: every pair
    evaluated once, all outputs written); the time the card takes to write
    two arrays of the outputs' size (``fill_``, the store floor, which
    overwrites ``got``); ``ptxas`` for ``kernel`` and the pack kernels."""
    import torch

    from repro_torch.kernels import (pack_bits, pack_planes_cuda,
                                     pack_words_cuda)
    for g, w in zip(other_entry(), got):
        check(torch.equal(g, w), "other entry == prepacked entry")
    g_, b, w = x.shape
    sw = -(-s // 32)
    xw = pack_words_cuda(x, s=s)
    want = pack_bits(x).view(g_, b, w // s, sw).transpose(1, 2)
    pack_equal = torch.equal(xw[:, :, :b], want)
    check(pack_equal, "pack kernel == pack_bits")
    del want
    check(torch.equal(pack_planes_cuda(p0, p1, s=s), words),
          "operand pack == prepared operands")
    first = [t[:, :1].contiguous() for t in (xw, words, kmax_t)]
    return {
        "pack_ms": cuda_ms(lambda: pack_words_cuda(x, s=s), 10, 2),
        "pack_equal": pack_equal,
        "plane_pack_ms": cuda_ms(lambda: pack_planes_cuda(p0, p1, s=s), 5, 1),
        "match_only_ms": cuda_ms(
            lambda: launch(xw, words, kmax_t, b, s), 10, 2),
        "division0_ms": cuda_ms(lambda: launch(*first, b, s), 10, 2),
        "store_floor_ms": cuda_ms(lambda: [t.fill_(1) for t in got], 10, 2),
        "ptxas": {kernel: ptxas_of(f"{kernel}ILi{sw}E"),
                  **({"word_classes": ptxas_of(f"word_classesILi{sw}E")}
                     if kernel == "packed_bits_kernel" else {}),
                  "pack_kernel_wide": ptxas_of("pack_kernel_wide"),
                  "pack_kernel": ptxas_of("pack_kernelEPKh")},
    }


def launch_packed(xw, vc, kmax_t, b: int, s: int):
    """The packed kernel's launch on G-leading (G = 1) packed operands."""
    from repro_torch.kernels._cuda import launch_packed_bits
    return [t[None] for t in launch_packed_bits(xw[0], vc[0], kmax_t[0], b,
                                                s)]


def packed_row(lay, x, km_np, km, shape: dict, launches: int, bw: float,
               rates: dict) -> dict:
    """Phase 4's packed row: the prepacked entry as the main path calls it
    (word pack + match) on ``prepare_match(engine="packed")`` operands with
    the SA kmax, held against the plain version (pack_words +
    ``tcam_match_packed_bits_ref``) and timed.  Its added figures: those of
    ``match_extra`` (the row-major entry against the prepacked one) and the
    same call at kmax = 0 (the main path's own operands), held against the
    plain version and timed (whole call and match alone): an extra figure
    of the row, not a second case."""
    import torch

    from repro_torch.core.lut import bitplanes
    from repro_torch.kernels import (pack_bits, pack_words, pack_words_cuda,
                                     prepare_match,
                                     tcam_match_packed_bits_cuda,
                                     tcam_match_packed_bits_ref,
                                     tcam_match_packed_cuda)
    dev, s, b = x.device, lay.s, x.shape[0]
    is0, is1 = (torch.from_numpy(p).to(dev) for p in bitplanes(lay.cells))
    care = is0 | is1
    sa_ops = prepare_match(lay.cells, s, km_np, engine="packed", device=dev)
    ideal_ops = prepare_match(lay.cells, s, None, engine="packed", device=dev)

    def plain(o):
        return tcam_match_packed_bits_ref(pack_words(x[None], s)[0], o.a,
                                          o.kmax, b)

    def extra(got):
        xq, val, cv = (pack_bits(t) for t in (x, is1, care))
        out = match_extra(
            [t[None] for t in got], x[None], is1[None], care[None],
            sa_ops.a[None], sa_ops.kmax[None], s,
            lambda: [t[None] for t in tcam_match_packed_cuda(
                xq, val, cv, km, s=s)],
            launch_packed, "packed_bits_kernel")
        del xq, val, cv

        def ideal_run():
            return tcam_match_packed_bits_cuda(x, ideal_ops.a, ideal_ops.kmax,
                                               s=s)
        k0 = ideal_run()
        torch.cuda.synchronize()
        for g, w in zip(k0, plain(ideal_ops)):
            check(torch.equal(g, w), "packed kernel at kmax = 0 == plain")
        nbytes = sum(t.numel() * t.element_size()
                     for t in (x, ideal_ops.a, ideal_ops.kmax, *k0))
        ops = packed_ops(k0[1], ideal_ops.kmax, s)
        terms = {"bytes": nbytes / bw * 1e3}
        terms.update({k: n / rates[k] * 1e3 for k, n in ops.items()})
        evals = int(k0[1].sum(dtype=torch.int64))
        del k0
        ms = cuda_ms(ideal_run, 10, 2)
        out["kmax0"] = {"ms": ms, "plain_equal": True, "bytes": nbytes,
                        "operations": ops, "bound_ms": max(terms.values()),
                        "bound_terms_ms": terms, "evaluated_divisions": evals,
                        "triples_per_s": evals / ms * 1e3}
        xw = pack_words_cuda(x[None], s=s)
        out["kmax0"]["match_only_ms"] = cuda_ms(lambda: launch_packed(
            xw, ideal_ops.a[None], ideal_ops.kmax[None], b, s), 10, 2)
        return out

    return measure("tcam_packed", [{
        "run": lambda: tcam_match_packed_bits_cuda(x, sa_ops.a, sa_ops.kmax,
                                                   s=s),
        "plain": lambda: plain(sa_ops), "library": None, "extra": extra,
        "inputs": (x, sa_ops.a, sa_ops.kmax),
        "ops": lambda got: packed_ops(got[1], sa_ops.kmax, s),
        "shape": shape,
    }], launches, bw, rates)


def hard_vote(trees, X, n_classes: int):
    """The ensemble's own decision: each tree's ``predict``, argmax of the
    vote counts with ties to the lowest class."""
    import numpy as np

    from repro_torch.core import predict
    votes = np.stack([predict(t, X) for t in trees])
    counts = np.zeros((X.shape[0], n_classes), np.int64)
    np.add.at(counts, (np.broadcast_to(np.arange(X.shape[0]), votes.shape),
                       votes), 1)
    return np.argmax(counts, axis=1)


def forest_phase(dev, bw: float, rates: dict):
    """Phase 6: the forest path.  Returns the banked kernel's record and the
    compiled forest (phase 7 serves it again)."""
    import numpy as np
    import torch

    from repro_torch.core import CELL_MM, DEFAULT_HW, apply_saf
    from repro_torch.dt import load_split
    from repro_torch.forest import (ForestExecutor, compile_forest,
                                    encode_group, forest_infer_ref,
                                    plan_forest, train_forest)
    from repro_torch.core import bitplanes
    from repro_torch.kernels import (prepare_banked, sa_kmax,
                                     tcam_match_banked_bits_cuda,
                                     tcam_match_banked_cuda,
                                     tcam_match_banked_plain)
    from repro_torch.kernels._cuda import launch_match_bits
    from repro_torch.serve import ServeConfig, TCAMServer

    Xtr, ytr, Xte, _ = load_split(FOREST_DATASET)
    t0 = time.perf_counter()
    trees = train_forest(Xtr, ytr, n_trees=FOREST_TREES)
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    forest = compile_forest(trees, s=FOREST_S)
    t_compile = time.perf_counter() - t0
    plan = plan_forest(forest)
    log(json.dumps({"forest": {
        "dataset": FOREST_DATASET, "trees": FOREST_TREES, "s": FOREST_S,
        "fit_s": t_fit,
        "compile_s": t_compile, "plan_id": plan.plan_id,
        "bank_rows": [int(l.cells.shape[0]) for l in forest.layouts],
        "bank_divisions": [int(l.n_cwd) for l in forest.layouts],
        "groups": [{"G": g.n_banks, "R": g.r_pad, "D": g.d_pad,
                    "W": g.width} for g in plan.groups]}}))
    golden = hard_vote(trees, Xte, forest.n_classes)

    # -- main path: ForestExecutor on the CUDA kernel ----------------------
    ex = ForestExecutor(forest, engine="mxu", device=dev, plan=plan)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ex.infer(Xte)
    t_first = time.perf_counter() - t0
    counts = read_counts()
    log(f"forest main path launches: {counts}")
    launches = counts["tcam_match_banked_bits_cuda"]
    check(counts["tcam_match_cuda"] == counts["tcam_match_bits_cuda"]
          == counts["tcam_match_packed_cuda"]
          == counts["tcam_match_packed_bits_cuda"] == 0,
          "the forest path launched no single-bank kernel")
    check(launches == plan.n_groups == counts["pack_words_cuda"],
          f"banked kernel and word pack launched once per group ({launches} "
          f"launches, {plan.n_groups} groups)")
    check(counts["path_tiled"] == launches and counts["path_any"] == 0,
          "every forest group took the tiled path")
    check(counts["pack_planes_cuda"] == plan.n_groups,
          "each group's planes were packed once, at prepare")
    check(np.array_equal(res.predictions, golden),
          "forest predictions equal the trees' hard vote")
    check(bool((res.n_survivors == 1).all()),
          "one survivor per bank and query")
    t0 = time.perf_counter()
    again = ex.infer(Xte)
    t_second = time.perf_counter() - t0
    same_result(res, again, "forest mxu, second call")
    log(json.dumps({"forest_infer": {
        "engine": "mxu", "queries": len(Xte), "first_call_ms": t_first * 1e3,
        "second_call_ms": t_second * 1e3,
        "accuracy_vs_vote": float((res.predictions == golden).mean()),
        "mean_active_evals_per_bank": float(res.active_evals.mean()),
        "energy_per_dec_nj":
            res.figures["aggregate"]["energy_per_dec_j"] * 1e9}}))
    del ex, again

    Xs = Xte[:FOREST_SLICE]
    want = ForestExecutor(forest, engine="mxu", device=dev,
                          plan=plan).infer(Xs)
    t0 = time.perf_counter()
    banked = ForestExecutor(forest, engine="banked", device=dev,
                            plan=plan).infer(Xs)
    t_banked = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = forest_infer_ref(forest, Xs)
    t_ref = time.perf_counter() - t0
    same_result(want, banked, "forest mxu vs banked", skip=("engine",))
    same_result(want, ref, "forest mxu vs ref", skip=("engine",))
    log(f"forest slice of {len(Xs)}: banked {t_banked * 1e3:.1f} ms, ref "
        f"(numpy oracle) {t_ref * 1e3:.1f} ms; every ForestResult field "
        "equal to mxu's")

    # -- the banked kernel at both group shapes -------------------------------
    rng = np.random.default_rng(1)
    cases = []
    for gi, grp in enumerate(plan.groups):
        km = np.array(grp.kmax0, copy=True)
        for slot, bank_id in enumerate(grp.bank_ids):
            lay = forest.banks[int(bank_id)].layout
            offsets = rng.normal(0.0, 0.08, (lay.cells.shape[0], lay.n_cwd))
            k = sa_kmax(lay, offsets)
            km[slot, : k.shape[0], : k.shape[1]] = k
        check(bool((km == -1).any() and (km == 0).any() and (km > 0).any()),
              f"group {gi}: kmax holds -1, 0 and >0")
        cells = grp.cells if gi else apply_saf(grp.cells, 0.01, 0.01, rng)
        check(bool((cells == CELL_MM).any()) == (gi == 0),
              f"group {gi}: CELL_MM cells only where faults were injected")
        ops = prepare_banked(cells, grp.s, km, engine="mxu", device=dev)
        x = torch.from_numpy(encode_group(forest, grp, Xte)).to(dev)
        is0, is1 = (torch.from_numpy(p).to(dev) for p in bitplanes(cells))
        k = torch.from_numpy(km).to(dev)
        xb16, p0b16 = x.to(torch.bfloat16), is0.to(torch.bfloat16)
        cases.append({
            "run": lambda x=x, o=ops: tcam_match_banked_bits_cuda(
                x, o.a, o.kmax, s=o.s),
            "plain": lambda x=x, a=is0, b=is1, k=k, s=grp.s:
                tcam_match_banked_plain(x, a, b, s, k),
            "library": lambda a=xb16, b=p0b16: torch.bmm(a, b.transpose(1, 2)),
            "extra": lambda got, x=x, a=is0, b=is1, k=k, o=ops: match_extra(
                got, x, a, b, o.a, o.kmax, o.s,
                lambda: tcam_match_banked_cuda(x, a, b, k, s=o.s),
                launch_match_bits, "match_bits_kernel"),
            "inputs": (x, ops.a, ops.kmax),
            "ops": lambda got, s=grp.s: bitplane_ops(got[1], s),
            "shape": {"G": grp.n_banks, "B": x.shape[1], "R": grp.r_pad,
                      "W": grp.width, "S": grp.s, "D": grp.d_pad,
                      "stuck_faults": gi == 0},
        })
    rec = measure("tcam_match_banked", cases, launches, bw, rates)
    rec["library_call"] = ("bf16 torch.bmm (G,B,W)x(G,W,R) per group: "
                           "products only")
    del cases

    # -- forest serving ---------------------------------------------------------
    n = min(SERVE_REQUESTS, len(Xte))
    active = res.active_evals[:, :n].sum(axis=0)
    energy = (active.astype(np.float64) * DEFAULT_HW.e_row
              + forest.n_banks * DEFAULT_HW.e_mem)
    # 'auto' resolves by device: the banked kernel ('mxu') on the card
    zero_counts()
    with TCAMServer(forest, config=ServeConfig(engine="auto", max_batch=256),
                    device=dev) as srv:
        t0 = time.perf_counter()
        builds = srv.warmup()
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        futs = srv.submit_many(Xte[:n])
        got = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        stats = srv.metrics()
    for f, arr in (("prediction", res.predictions[:n]),
                   ("active_evals", active), ("energy_j", energy),
                   ("n_survivors", np.full(n, forest.n_banks))):
        check(np.array_equal([getattr(r, f) for r in got], arr),
              f"forest served (auto) {f} equals the executor's")
    kernel_launches = tcam_match_banked_bits_cuda.launches
    check(stats["engine"] == "mxu" and kernel_launches > 0,
          f"forest serving on auto resolved to {stats['engine']} and "
          f"launched the banked kernel {kernel_launches} times")
    cl = stats["compute_latency"]
    serve = {"auto": {
        "resolved_engine": stats["engine"], "requests": n,
        "warmup_builds": builds, "warmup_s": t_warm, "wall_s": wall,
        "requests_per_s": n / wall, "batches": stats["batches"],
        "mean_batch_fill": stats["mean_batch_fill"],
        "compute_p50_ms": cl["p50_ms"], "compute_p99_ms": cl["p99_ms"],
        "total_p50_ms": stats["total_latency"]["p50_ms"],
        "total_p99_ms": stats["total_latency"]["p99_ms"],
        "banked_launches": kernel_launches}}
    log(json.dumps({"forest_serve": serve}))
    return rec, forest


def serve_timed(srv, X, timeout: float = 600.0) -> tuple[list, float]:
    """Submit every row of ``X`` to a background server and wait for all;
    returns the results and the wall seconds."""
    t0 = time.perf_counter()
    futs = srv.submit_many(X)
    res = [f.result(timeout=timeout) for f in futs]
    return res, time.perf_counter() - t0


def serve_figures(srv, n: int, wall: float) -> dict:
    stats = srv.metrics()
    cl = stats["compute_latency"]
    return {"engine": stats["engine"], "requests": n, "wall_s": wall,
            "requests_per_s": n / wall, "batches": stats["batches"],
            "compute_p50_ms": cl["p50_ms"], "compute_p99_ms": cl["p99_ms"]}


def check_served(res, want, what: str) -> None:
    """Served results against a ``SimResult`` of the same queries."""
    import numpy as np
    for f, arr in (("prediction", want.predictions),
                   ("survivor", want.survivors),
                   ("n_survivors", want.n_survivors),
                   ("active_evals", want.active_evals)):
        check(np.array_equal([getattr(r, f) for r in res], arr[:len(res)]),
              f"{what}: served {f} equals tcam_infer's")


def match_launches() -> int:
    """Launches of the two single-bank match kernels so far."""
    from repro_torch import kernels as tk
    return (tk.tcam_match_bits_cuda.launches
            + tk.tcam_match_packed_bits_cuda.launches)


def health_phase(dev, tree, Xtr, ytr, Xte, golden, ideal, forest) -> None:
    """Phase 7: chip health (BIST, repair, canary and breaker, k-chip
    voting) and the model lifecycle on the card, at credit width.  ``tree``
    is phase 3's credit tree, ``golden`` its own predictions on ``Xte`` and
    ``ideal`` its ideal ``tcam_infer`` result there (LUT rows as survivors);
    ``forest`` is phase 6's credit forest."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from repro_torch.core import (NonIdealSpec, compile_tree, encode_inputs,
                                  train_tree)
    from repro_torch.dt import DATASETS
    from repro_torch.kernels import tcam_infer, tcam_match_banked_bits_cuda
    from repro_torch.lifecycle import (ModelRegistry, WearTracker,
                                       content_hash, plan_delta, plan_full)
    from repro_torch.reliability import (ReplicatedServer,
                                         behavior_changed_rows,
                                         first_survivors, row_utilization,
                                         row_utilization_ref, run_bist,
                                         run_bist_ref)
    from repro_torch.serve import ServeConfig, TCAMServer

    n = min(SERVE_REQUESTS, len(Xte))
    Xq = Xte[:n]
    t_phase = time.perf_counter()
    zero_counts()

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- serving with a canary after every batch (ideal chip) -----------------
    compiled = compile_tree(tree, s=128, spare_rows=HEALTH_SPARES)
    lay = compiled.layout
    used = 1 + lay.width
    check(lay.cells.shape == (8832, 4992) and lay.n_rows == 8476,
          f"credit layout with spares {lay.cells.shape}")
    xq = encode_inputs(compiled.lut, Xq)
    live = tcam_infer(lay, xq, device=dev)
    check(np.array_equal(live.predictions, golden[:n])
          and np.array_equal(live.survivors, ideal.survivors[:n]),
          "the layout with spares answers as phase 3's")
    with TCAMServer(compiled, device=dev,
                    config=ServeConfig(max_batch=256,
                                       canary_every_batches=1)) as srv:
        srv.warmup()
        res, wall = serve_timed(srv, Xq)
    # read after close: the worker runs each batch's canary after resolving
    # the batch's futures
    fig = serve_figures(srv, n, wall)
    fig["canary_runs"] = srv.metrics()["reliability"]["canary_runs"]
    check(srv.health()["state"] == "healthy", "ideal chip stays healthy")
    check(fig["canary_runs"] == fig["batches"], "one canary per batch")
    check_served(res, live, "serving with the canary")
    fig["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"health_canary_serve": fig}))

    # every later step's server does its host set-up (stuck-fault draws,
    # the canary's host matching, a second fit) here, in a pool that is
    # drained before the first timed step, so no step's time carries it
    spec = DATASETS["credit"]

    def stuck(p: float) -> NonIdealSpec:
        return NonIdealSpec(p_sa0=p, p_sa1=p)

    def fit_candidate():
        t0 = time.perf_counter()
        tree2 = train_tree(Xtr, ytr, max_depth=spec.max_depth,
                           max_leaves=spec.max_leaves // 2,
                           min_samples_leaf=spec.min_samples_leaf)
        cand = compile_tree(tree2, s=128, spare_rows=HEALTH_SPARES)
        return cand, time.perf_counter() - t0

    cfg = ServeConfig(max_batch=256, canary_every_batches=1, auto_repair=True,
                      canary_threshold=BREAKER_THRESHOLD)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        pending = {
            "bist": pool.submit(TCAMServer, compiled, device=dev,
                                rng=np.random.default_rng(0),
                                nonideal=stuck(HEALTH_P),
                                config=ServeConfig(max_batch=256,
                                                   engine="auto")),
            "scan": [pool.submit(TCAMServer, compiled, device=dev,
                                 config=cfg, rng=np.random.default_rng(seed),
                                 nonideal=stuck(BREAKER_P))
                     for seed in BREAKER_SEEDS],
            "forest": [pool.submit(TCAMServer, forest, device=dev,
                                   nonideal=stuck(FOREST_HEALTH_P),
                                   rng=np.random.default_rng(0),
                                   config=ServeConfig(max_batch=256,
                                                      engine=engine))
                       for engine in ("auto", "banked")],
            "replicated": pool.submit(
                ReplicatedServer, compiled, k=REPLICAS, device=dev,
                rng=np.random.default_rng(0), nonideal=stuck(HEALTH_P),
                config=ServeConfig(max_batch=256, background=False)),
            "live": pool.submit(TCAMServer, compiled, device=dev,
                                config=ServeConfig(max_batch=256)),
            "candidate": pool.submit(fit_candidate),
        }
        ready = {k: [f.result() for f in v] if isinstance(v, list)
                 else v.result() for k, v in pending.items()}
    log(json.dumps({"health_setup": {
        "phase_s": time.perf_counter() - t_phase,
        "setup_s": time.perf_counter() - t0, "threads": HOST_THREADS}}))

    # -- BIST and repair -----------------------------------------------------------
    srv = ready["bist"]
    actual, intent = srv.live_layout.cells, srv.live_intent
    bist, t_bist = sync_time(srv.self_test)
    changed = behavior_changed_rows(intent, actual, used)
    check(np.array_equal(bist.detected, changed),
          "BIST on the card flags exactly the behaviourally changed rows "
          f"({bist.n_defective} flagged, {int(changed.sum())} changed)")
    detected = bist.defective_rows
    clean = np.flatnonzero(~bist.detected)
    n_clean = BIST_REF_ROWS - min(len(detected), BIST_REF_ROWS * 3 // 4)
    rows = np.concatenate([detected[: BIST_REF_ROWS - n_clean],
                           clean[:: max(1, len(clean) // n_clean)][:n_clean]])
    # the rows' grids, copied before repair rewrites the chip; the plain
    # loop runs on them at the end of the phase
    bist_rows = (actual[rows], intent[rows])
    sub = run_bist(*bist_rows, used=used, n_rows=lay.n_rows, device=dev)
    check(np.array_equal(sub.detected, bist.detected[rows]),
          "BIST on the card of the sampled rows alone == of the whole chip")
    report, t_repair = sync_time(lambda: srv.repair(bist))
    summary = report.summary()
    again = srv.self_test()
    check(report.degraded or again.n_defective == 0,
          "the re-test after a full repair is clean")
    zero = match_launches()
    res, wall = serve_timed(srv, Xq)
    served_launches = match_launches() - zero
    rlay = srv.live_layout
    want = tcam_infer(rlay, xq, engine=srv.engine, device=dev)
    check_served(res, want, "repaired chip")
    on_spares = int(sum(r.survivor >= lay.n_rows for r in res))
    remapped = [q for q, r in enumerate(live.survivors)
                if int(r) in report.assignments]
    follow = sum(res[q].survivor == report.assignments[int(live.survivors[q])]
                 for q in remapped)
    check(on_spares > 0, "served survivors land on remapped spare rows")
    check(served_launches >= srv.metrics()["batches"] > 0,
          "every served batch launched a match kernel")
    log(json.dumps({"health_bist_repair": {
        "phase_s": time.perf_counter() - t_phase,
        "layout": list(lay.cells.shape), "p_sa": HEALTH_P,
        "bist_ms": t_bist * 1e3, "defective_rows": bist.n_defective,
        "defective_lut_rows": bist.summary()["defective_lut_rows"],
        "probes_run": bist.probes_run,
        "behavior_changed_rows": int(changed.sum()),
        "coverage": bist.coverage(changed),
        "repair_ms": t_repair * 1e3, "repair": summary,
        "retest_defective": again.n_defective,
        "served": {**serve_figures(srv, n, wall),
                   "match_launches": served_launches,
                   "accuracy_vs_tree": float(np.mean(
                       [r.prediction for r in res] == golden[:n])),
                   "survivors_on_spares": on_spares,
                   "queries_on_remapped_rules": len(remapped),
                   "of_them_on_their_spare": int(follow)}}}))
    srv.close()

    # -- the breaker's ladder ------------------------------------------------------
    srv, firsts = None, []
    for candidate in ready["scan"]:
        if srv is None:
            firsts.append(candidate.run_canary())
            if firsts[-1] < cfg.canary_threshold:
                srv = candidate
                continue
        candidate.close()
    log(f"breaker: first canary by seed {firsts}")
    seed = BREAKER_SEEDS[len(firsts) - 1]
    check(srv is not None, f"a canary trips at p={BREAKER_P} for one of "
          f"seeds {list(BREAKER_SEEDS)}")
    batches = []
    srv.fault_injection_hook = lambda X: batches.append(
        (srv.engine, srv.breaker.state, srv.breaker.trips, match_launches()))
    res, wall = serve_timed(srv, Xq)
    srv.close()
    end = match_launches()
    health = srv.health()
    marks = [b[3] for b in batches] + [end]
    per_batch = [marks[i + 1] - marks[i] for i in range(len(batches))]
    # the first batch that starts after the breaker tripped
    trip = next((i for i, b in enumerate(batches) if b[2] > 0), len(batches))
    check(health["breaker"]["trips"] >= 1 and trip < len(batches),
          "the breaker tripped before the last batch")
    check(all(b[0] != "ref" for b in batches) and health["engine"] != "ref"
          and health["state"] != "fallback",
          f"the breaker kept serving on the kernel (state {health['state']},"
          f" engine {health['engine']})")
    check(all(k > 0 for k in per_batch),
          "every batch, before and after the trip, launched a match kernel")
    # the kernel's canary on the grid it serves now == the plain version's
    probe = srv._canary
    plain = tcam_infer(srv.live_layout, probe.words[:, 1:used], engine="ref",
                       device=dev)
    canary_kernel = srv.run_canary()
    canary_plain = probe.accuracy(plain.predictions)
    check(canary_kernel == canary_plain,
          f"canary on the kernel {canary_kernel} == on the plain version "
          f"{canary_plain}")
    log(json.dumps({"health_breaker": {
        "phase_s": time.perf_counter() - t_phase,
        "p_sa": BREAKER_P, "threshold": BREAKER_THRESHOLD, "seed": seed,
        "first_canary": firsts[-1],
        "state": health["state"], "engine": health["engine"],
        "trips": health["breaker"]["trips"],
        "recovery": health["breaker"]["recovery"],
        "repair_attempts": health["repair_attempts"],
        "last_repair": health["last_repair"],
        "canary_after": canary_kernel,
        "batches": len(batches),
        "launches_through_trip": sum(per_batch[:trip]),
        "launches_after_trip": sum(per_batch[trip:]),
        "wall_s": wall, "requests_per_s": n / wall}}))

    # -- row_utilization over the training inputs ------------------------------
    xtr = encode_inputs(compiled.lut, Xtr)

    def utilization():
        first = first_survivors(lay, xtr, device=dev)
        util = torch.bincount(first[first >= 0], minlength=lay.cells.shape[0])
        return first.cpu().numpy(), util.cpu().numpy()

    (first, util), t_util = sync_time(utilization)
    check(np.array_equal(util, row_utilization(lay, xtr, device=dev)),
          "row_utilization == the timed launch's first-survivor counts")
    check(int(util.sum()) == len(xtr) and util[lay.n_rows:].sum() == 0,
          "every training input has one first survivor, on a LUT row")
    head = first[:UTIL_REF_INPUTS]
    util_head = np.bincount(head[head >= 0], minlength=lay.cells.shape[0])
    log(json.dumps({"health_row_utilization": {
        "phase_s": time.perf_counter() - t_phase,
        "inputs": len(xtr), "ms": t_util * 1e3,
        "rows_used": int((util > 0).sum()), "max_hits": int(util.max())}}))

    # -- forest: per-bank BIST and repair --------------------------------------
    served = {}
    for engine, fsrv in zip(("auto", "banked"), ready["forest"]):
        bists, t_fb = sync_time(fsrv.self_test)
        reports, t_fr = sync_time(lambda: fsrv.repair(bists))
        before = tcam_match_banked_bits_cuda.launches
        fres, wall = serve_timed(fsrv, Xq)
        fh = fsrv.health()
        served[engine] = fres
        log(json.dumps({"health_forest": {
            "phase_s": time.perf_counter() - t_phase,
            "engine": fsrv.engine, "p_sa": FOREST_HEALTH_P,
            "bist_ms": t_fb * 1e3, "repair_ms": t_fr * 1e3,
            "banks_flagged": int(sum(b.n_defective > 0 for b in bists)),
            "rows_flagged": int(sum(b.n_defective for b in bists)),
            "rows_repaired": int(sum(r.rows_repaired for r in reports)),
            "banks_enabled": fh["banks_enabled"],
            "spares_free": fh["spares_free"],
            "banked_launches": tcam_match_banked_bits_cuda.launches - before,
            **serve_figures(fsrv, n, wall)}}))
        check(fsrv.engine == ("mxu" if engine == "auto" else "banked"),
              f"forest {engine} resolves by device")
        check((tcam_match_banked_bits_cuda.launches > before)
              == (engine == "auto"), f"forest {engine}: banked kernel launches")
        fsrv.close()
    check(sum(b.n_defective > 0 for b in bists) > 1,
          "faults flag rows in several banks")
    for f in ("prediction", "n_survivors", "active_evals", "energy_j"):
        check([getattr(r, f) for r in served["auto"]]
              == [getattr(r, f) for r in served["banked"]],
              f"repaired forest on mxu == on banked: {f}")

    # -- k-chip voting ---------------------------------------------------------------
    zero = match_launches()
    with ready["replicated"] as rs:
        t0 = time.perf_counter()
        voted = rs.serve(Xq)
        wall = time.perf_counter() - t0
        met = rs.metrics()
    launches = match_launches() - zero
    batches = [m["batches"] for m in met["replicas"]]
    check(launches == sum(batches), "one match launch per replica batch")
    log(json.dumps({"health_replicated": {
        "phase_s": time.perf_counter() - t_phase,
        "k": REPLICAS, "p_sa": HEALTH_P, "wall_s": wall,
        "requests_per_s": n / wall,
        "disagreement_rate": met["disagreement_rate"],
        "accuracy_vs_tree": float(np.mean(
            [v.prediction for v in voted] == golden[:n])),
        "replicas": [{"engine": m["engine"], "batches": b,
                      "launches": b} for m, b in zip(met["replicas"],
                                                     batches)]}}))

    # -- lifecycle ---------------------------------------------------------------------
    cand, t_fit = ready["candidate"]
    srv = ready["live"]
    old_cells, old_bits = srv.live_intent, srv.live_layout.class_bits
    plan, t_plan = sync_time(lambda: plan_delta(
        old_cells, cand.layout.cells, old_class_bits=old_bits,
        new_class_bits=cand.layout.class_bits))
    wear = WearTracker()
    wear.record(plan_full(np.zeros((0, 0), np.int8), old_cells,
                          new_class_bits=old_bits))
    wear.record(plan)
    _, t_stage = sync_time(lambda: srv.stage(cand, mirror_fraction=0.5))
    res_live, wall_shadow = serve_timed(srv, Xq)
    check_served(res_live, live, "live model while a candidate is staged")
    rep, t_promote = sync_time(lambda: srv.promote(min_shadow_batches=1,
                                                   max_disagreement=1.0))
    check(rep.promoted, f"promotion: {rep.reason}")
    res_new, _ = serve_timed(srv, Xq)
    check_served(res_new, tcam_infer(cand.layout, encode_inputs(cand.lut, Xq),
                                     device=dev), "promoted candidate")
    check(srv.rollback() == "reverted", "rollback reverts")
    res_old, _ = serve_timed(srv, Xq)
    check_served(res_old, live, "rolled-back model")
    lifecycle = srv.metrics()["lifecycle"]
    srv.close()
    with tempfile.TemporaryDirectory() as root:
        reg = ModelRegistry(root)
        t0 = time.perf_counter()
        v1 = reg.publish(compiled, "credit")
        v2 = reg.publish(cand, "credit", parents=[v1.version_id])
        back = [reg.load(v.version_id) for v in (v1, v2)]
        t_reg = time.perf_counter() - t0
    for v, model, b in zip((v1, v2), (compiled, cand), back):
        check(content_hash(b) == v.content_hash
              and np.array_equal(b.layout.cells, model.layout.cells),
              f"registry round trip of {v.version_id}")
    log(json.dumps({"health_lifecycle": {
        "phase_s": time.perf_counter() - t_phase,
        "candidate_fit_compile_s": t_fit,
        "candidate_layout": list(cand.layout.cells.shape),
        "plan_ms": t_plan * 1e3, "plan": plan.summary(),
        "figures": plan.figures(),
        "wear": wear.snapshot(), "stage_s": t_stage,
        "shadow_requests_per_s": n / wall_shadow,
        "promote_ms": t_promote * 1e3, "promotion": rep.summary(),
        "lifecycle": lifecycle, "registry_s": t_reg,
        "versions": [v1.version_id, v2.version_id]}}))

    counts = read_counts()
    log(f"phase 7 launches: {counts}")

    # -- the plain versions, on the host, after every timed step ----------------
    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    def bist_ref(i):
        a, b = (g[i:i + 1] for g in bist_rows)
        return run_bist_ref(a, b, used=used, n_rows=lay.n_rows)

    x_head = xtr[:UTIL_REF_INPUTS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        util_jobs = [pool.submit(timed, row_utilization_ref, lay,
                                 x_head[i:i + UTIL_REF_CHUNK])
                     for i in range(0, len(x_head), UTIL_REF_CHUNK)]
        bist_jobs = [pool.submit(timed, bist_ref, i) for i in range(len(rows))]
        util_done = [j.result() for j in util_jobs]
        bist_done = [j.result() for j in bist_jobs]
    t_refs = time.perf_counter() - t0
    want_util = sum(u for u, _ in util_done)
    check(np.array_equal(util_head, want_util),
          f"the timed row_utilization launch == the plain version on its "
          f"first {len(x_head)} inputs")
    ref_detected = np.array([r.detected[0] for r, _ in bist_done])
    check(np.array_equal(sub.detected, ref_detected)
          and sub.probes_run == sum(r.probes_run for r, _ in bist_done),
          f"BIST on the card == the plain per-row loop on {len(rows)} rows "
          f"({int(ref_detected.sum())} flagged)")
    log(json.dumps({"health_plain_versions": {
        "phase_s": time.perf_counter() - t_phase,
        "threads": HOST_THREADS, "wall_s": t_refs,
        "bist_rows": len(rows), "bist_flagged": int(ref_detected.sum()),
        "bist_ms_per_row": sum(t for _, t in bist_done) / len(rows) * 1e3,
        "util_inputs": len(x_head),
        "util_ms_per_input": sum(t for _, t in util_done) / len(x_head) * 1e3
    }}))
    check(counts["tcam_match_bits_cuda"] > 0
          and counts["tcam_match_packed_bits_cuda"] > 0
          and counts["tcam_match_banked_bits_cuda"] > 0,
          "the bitplane, packed and banked kernels each launched in phase 7")
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s")


def sync_time(fn):
    """``fn()`` between two device syncs; returns (result, wall seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class ScrubParts:
    """Times the parts of one ``TCAMServer.scrub_now`` call apart: the
    margins, the refresh plan, its figures, the wear ledger's record and
    the served grid's refresh.  Each part is wrapped with device syncs while
    the context is open and restored after."""

    def __init__(self, srv):
        from repro_torch.degradation import scheduler
        from repro_torch.lifecycle import WritePlan
        self.times: dict = {}
        self._patches = [
            (scheduler, "plan_refresh", "plan"),
            (WritePlan, "figures", "figures"),
            (srv._wear, "record", "wear_record"),
            (srv, "_compute_margins", "margins"),
            (srv, "_refresh_served_layout", "refresh"),
        ]
        self._saved: list = []

    def __enter__(self):
        for owner, attr, key in self._patches:
            orig = getattr(owner, attr)
            had = attr in vars(owner)
            self._saved.append((owner, attr, had, vars(owner).get(attr)))

            def wrapped(*a, _orig=orig, _key=key, **k):
                out, dt = sync_time(lambda: _orig(*a, **k))
                self.times[_key] = self.times.get(_key, 0.0) + dt
                return out
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, had, value in reversed(self._saved):
            if had:
                setattr(owner, attr, value)
            else:
                delattr(owner, attr)


def drift_phase(dev, compiled, Xte, golden, ideal) -> None:
    """Phase 8: drift, margins and scrub on the card at credit width.
    ``compiled`` is phase 3's credit tree (8576 x 4992 cells), ``golden``
    its own predictions on ``Xte`` and ``ideal`` its ideal ``tcam_infer``
    result there."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from repro_torch.core import (DriftSpec, NonIdealSpec, encode_inputs,
                                  sample_drift)
    from repro_torch.core.lut import CELL_MM, CELL_X
    from repro_torch.degradation import layout_margins_ref
    from repro_torch.kernels import tcam_infer
    from repro_torch.serve import ServeConfig, TCAMServer

    n = min(SERVE_REQUESTS, len(Xte))
    Xq = Xte[:n]
    xq = encode_inputs(compiled.lut, Xq)
    lay = compiled.layout
    spec = NonIdealSpec(drift=DriftSpec(**DRIFT_LAW))
    kernel_engines = ("packed", "mxu")
    t_phase = time.perf_counter()
    zero_counts()

    # -- set-up: the exponents alone, then the phase's three servers --------
    model, t_sample = sync_time(lambda: sample_drift(
        lay.cells.shape, spec.drift, np.random.default_rng(DRIFT_SEED),
        device=dev))
    check(model.nu_r1.device.type == dev.type
          and model.nu_r1.dtype == torch.float64,
          "drift exponents live on the card in float64")
    del model

    def server(**cfg):
        return TCAMServer(compiled, device=dev, nonideal=spec,
                          rng=np.random.default_rng(DRIFT_SEED),
                          config=ServeConfig(max_batch=256,
                                             scrub_margin_v=DRIFT_MARGIN_V,
                                             **cfg))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(server),
                pool.submit(server, scrub_every_batches=1,
                            scrub_policy="periodic",
                            scrub_period_s=DRIFT_PERIOD_S,
                            time_per_batch_s=DRIFT_BATCH_S),
                pool.submit(server, canary_every_batches=1)]
        srv, periodic, tripped = [j.result() for j in jobs]
    t_setup = time.perf_counter() - t0
    for s in (srv, periodic, tripped):
        s.warmup()
    log(json.dumps({"drift_setup": {
        "sample_drift_s": t_sample, "servers_s": t_setup,
        "phase_s": time.perf_counter() - t_phase}}))

    # -- fresh -----------------------------------------------------------------
    check(srv.drift_enabled and srv.engine == "packed",
          "a fresh drift chip serves on packed")
    fresh, wall = serve_timed(srv, Xq)
    check_served(fresh, ideal, "fresh drift chip")
    log(json.dumps({"drift_fresh_serve": serve_figures(srv, n, wall)}))

    def answers(res):
        return [(r.prediction, r.survivor, r.n_survivors, r.active_evals)
                for r in res]

    # -- the accelerated-aging sweep --------------------------------------------
    sch = srv._scrub
    steps, scrub, host = [], None, None
    for age in DRIFT_AGES:
        _, t_adv = sync_time(lambda: srv.advance_time(age - sch.now))
        base = srv._cells_on_device("base", srv._base_layout)
        _, t_read = sync_time(lambda: srv._drift.readout(
            base, sch.ages(), sch.reads))
        cells = srv.live_layout.cells
        if age == DRIFT_REF_AGE:
            # the served grid and the margins against the copied numpy
            # bodies on the host, at the same stress
            ref, t_read_ref = sync_time(lambda: srv._drift.readout_ref(
                srv._base_layout.cells, sch.ages(), sch.reads))
            ref[:, 1 + lay.width:] = CELL_X
            check(np.array_equal(cells, ref),
                  f"served grid at {age:g} s == the numpy readout over all "
                  f"{cells.size} cells")
            got, t_marg_card = sync_time(srv.margins)
            want, t_marg_ref = sync_time(lambda: layout_margins_ref(
                srv._base_layout, srv._drift, sch.ages(), sch.reads))
            err = float(np.max(np.abs(got.margin - want.margin)))
            check(np.allclose(got.margin_match, want.margin_match,
                              rtol=1e-12, atol=1e-15)
                  and np.allclose(got.margin_mismatch, want.margin_mismatch,
                                  rtol=1e-12, atol=1e-15)
                  and np.array_equal(sch.due(got.margin),
                                     sch.due(want.margin)),
                  f"margins at {age:g} s within rtol 1e-12 / atol 1e-15 of "
                  f"the numpy loop, rows due equal")
            host = {"age_s": age, "readout_card_ms": t_read * 1e3,
                    "readout_host_ms": t_read_ref * 1e3,
                    "margins_card_ms": t_marg_card * 1e3,
                    "margins_host_ms": t_marg_ref * 1e3,
                    "margins_max_abs_err": err}
        _, t_warm = sync_time(srv.warmup)
        m, t_marg = sync_time(srv.margins)
        due = sch.due(m.margin)
        engine = srv.engine
        check(engine == ("mxu" if (cells == CELL_MM).any() else "packed"),
              f"auto resolves to {engine} at {age:g} s")
        res, wall = serve_timed(srv, Xq)
        step = {"age_s": age, "advance_ms": t_adv * 1e3,
                "readout_ms": t_read * 1e3, "rebuild_warmup_ms": t_warm * 1e3,
                "margins_ms": t_marg * 1e3,
                "cells_changed": int((cells != lay.cells).sum()),
                "cell_mm": int((cells == CELL_MM).sum()),
                "rows_negative": m.summary()["rows_negative"],
                "margin_min_v": m.summary()["min_v"],
                "rows_due": int(due.size), "engine": engine,
                "accuracy_vs_tree": float(np.mean(
                    [r.prediction for r in res] == golden[:n])),
                "requests_per_s": n / wall}
        steps.append(step)
        log(json.dumps({"drift_age": step}))
        if scrub is not None or not due.size:
            continue
        # the first age with rows due: a margin scrub, timed part by part
        with ScrubParts(srv) as parts:
            rep, t_scrub = sync_time(srv.scrub_now)
        check(np.array_equal(rep.rows_refreshed, due),
              "the margin scrub refreshed the rows due")
        res, wall = serve_timed(srv, Xq)
        check(srv.engine in kernel_engines, "served on a kernel")
        plain = tcam_infer(srv.live_layout, xq[:DRIFT_PLAIN_QUERIES],
                           engine="ref", device=dev)
        check_served(res[:DRIFT_PLAIN_QUERIES], plain,
                     "after a margin scrub, against the plain version")
        forced, t_force = sync_time(lambda: srv.scrub_now(force=True))
        check(forced.n_refreshed == lay.cells.shape[0]
              and np.array_equal(srv.live_layout.cells, lay.cells)
              and srv.engine == "packed",
              "a forced scrub restores the fresh grid, on packed")
        again, _ = serve_timed(srv, Xq)
        check(answers(again) == answers(fresh),
              "after a forced scrub serving equals the fresh answers")
        scrub = {"age_s": age, "report": rep.summary(),
                 "scrub_now_s": t_scrub,
                 "parts_s": parts.times,
                 "served_after_requests_per_s": n / wall,
                 "forced": forced.summary(), "forced_s": t_force}
        log(json.dumps({"drift_scrub": scrub}))
    check(scrub is not None, "some age had rows due under the margin policy")
    check(host is not None, "the reference age was in the sweep")
    check(steps[-1]["rows_negative"] > 0 and steps[-1]["engine"] == "mxu",
          "the oldest chip has negative margins and CELL_MM")
    srv.close()

    # -- serving with a periodic scrub after every batch ------------------------
    Xs = Xte[:DRIFT_SCRUB_REQUESTS]
    res, wall = serve_timed(periodic, Xs)
    periodic.close()
    fig = serve_figures(periodic, len(Xs), wall)
    deg = periodic.metrics()["degradation"]
    check(deg["scrub_passes"] == fig["batches"] and deg["rows_scrubbed"] > 0
          and periodic.engine in kernel_engines,
          "a scrub pass after every batch, rows refreshed, on a kernel")
    fig.update(degradation=deg,
               health=periodic.health()["degradation"]["margins"])
    log(json.dumps({"drift_periodic_serve": fig}))

    # -- a breaker tripped by an aged chip ----------------------------------------
    tripped.advance_time(DRIFT_REF_AGE)
    res, wall = serve_timed(tripped, Xq[:DRIFT_TRIP_REQUESTS])
    tripped.close()
    h = tripped.health()
    check(h["breaker"]["trips"] >= 1 and h["breaker"]["recovery"] == "scrub"
          and h["repair_attempts"] == 0 and tripped.engine in kernel_engines,
          f"the aged chip's breaker recovers on the scrub rung: {h['breaker']}")
    log(json.dumps({"drift_breaker": {
        "breaker": h["breaker"], "state": h["state"],
        "engine": tripped.engine,
        "requests_per_s": DRIFT_TRIP_REQUESTS / wall,
        "degradation": tripped.metrics()["degradation"]}}))

    counts = read_counts()
    log(f"phase 8 launches: {counts}")
    log(json.dumps({"drift_host_vs_card": host}))
    check(counts["tcam_match_bits_cuda"] > 0
          and counts["tcam_match_packed_bits_cuda"] > 0,
          "the bitplane and packed kernels each launched in phase 8")
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s")


def lm_work(cfg, weight_bytes: int, batch: int, seq: int,
            cache_len: int = 0, experts_read: int | None = None) -> dict:
    """What one ``prefill`` of ``batch`` x ``seq`` tokens (``cache_len`` 0)
    or one ``decode_step`` of ``batch`` tokens over a ``cache_len`` cache
    does: bf16 and f32 operations and the bytes moved, layer by layer of
    ``cfg.pattern``.  ``t`` is the step's tokens (batch x seq, or batch);
    a multiply-add counts two operations.

    Bytes: ``weight_bytes`` (every weight the step reads in full, once),
    the embedding rows gathered (4*t*d; an encoder-decoder's positional
    rows as many again), the last logits written (2*batch*V), and per layer
    its cache or state written (prefill) or read and written (decode): an
    attention layer's bf16 K/V (2*batch*keys*kv*hd*2), mamba's conv rows
    and f32 SSM state (batch*((K-1)*Di*2 + Di*N*4)), rwkv's token shift and
    f32 WKV state (batch*(2*d + 4*d*hd)), the channel mix's shift
    (2*batch*d), cross-attention's encoder K/V (2*batch*S_enc*H*hd*2);
    in prefill an encoder reads its f32 frames (4*batch*S_enc*d).

    ``"reference"`` counts the work as the reference computes it,
    ``"function"`` what the function needs; they differ where noted:

    - attention: projections 2t*d*(H+2KV)*hd + 2t*H*hd*d in bf16; the
      query-key products and the weighted values, 4*H*hd per pair, in f32
      over every block of the chunked attention (batch*seq*keys pairs;
      causal masking wastes about half in prefill) for the reference, in
      bf16 over the causal pairs for the function;
    - mamba (both): in/out projections 2t*d*2Di + 2t*Di*d in bf16; in f32
      the K-tap conv 2K*t*Di, x_proj 2t*Di*(R+2N), dt_w 2t*R*Di and the
      scan's 8 operations per (token, Di, N) (exp(dt*a), dt*B*x,
      dA*h + dBx, the product with C);
    - rwkv: the r/k/v/g/o projections 10t*d^2 in bf16, the low-rank decay
      4t*d*64 in f32 (both); the WKV in f32: chunked (chunk C, the largest
      divisor of seq <= 16) t*d*(4C + 4hd) for the reference (r·kᵀ and
      its product with v over the whole C x C block, r·S_in and kᵀv per
      token), the token recurrence t*d*(5hd + 4) for the function;
    - MLP 6t*d*F in bf16; channel mix 4t*d*F + 2t*d^2 in bf16; MoE's
      router 2t*d*E in f32 (both) and its experts 6*d*F per slot in bf16:
      every capacity slot of every token group (reference) or the t*k
      dispatched rows (function), and of the experts' weights the
      function reads only the ``experts_read`` (summed over MoE layers;
      all if None) that the tokens chose;
    - cross-attention (every decoder layer): q and o projections
      4t*d*H*hd in bf16 (both), in prefill also the encoder's K and V
      4*batch*S_enc*d*H*hd; 4*H*hd per (query, encoder key) pair over
      t*S_enc pairs, f32 (reference) or bf16 (function);
    - encoder (prefill only): per layer the attention projections and the
      MLP over batch*S_enc frames in bf16, and 4*H*hd per pair over the
      batch*S_enc^2 non-causal pairs, f32 (reference) or bf16 (function);
    - the head 2*batch*d*V in bf16.

    No configuration here runs a sliding window."""
    from repro_torch.models.attention import _fit
    from repro_torch.models.moe import capacity
    d, v = cfg.d_model, cfg.vocab_size
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f = cfg.d_ff
    di, n_st, k_conv, r = (cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
                           cfg.dt_rank)
    t = batch * seq
    keys = cache_len or seq
    rw = 2 if cache_len else 1          # state written, or read and written
    causal_pairs = (batch * cache_len if cache_len
                    else batch * seq * (seq + 1) // 2)
    qk_pv = 2 * 2 * nh * hd                         # per query-key pair
    proj = 2 * t * d * (nh + 2 * kv) * hd + 2 * t * nh * hd * d
    work = {w: {"bf16_ops": 0, "f32_ops": 0, "bytes": 0}
            for w in ("reference", "function")}

    def add(kind, ref, fn=None):
        work["reference"][kind] += ref
        work["function"][kind] += ref if fn is None else fn

    n_moe = 0
    for layer in cfg.pattern * cfg.n_repeat:
        mixer, ffn = layer.split("+")
        if mixer in ("attn", "swa"):
            add("bf16_ops", proj, proj + qk_pv * causal_pairs)
            add("f32_ops", qk_pv * batch * seq * keys, 0)
            add("bytes", 2 * batch * keys * kv * hd * 2)
        elif mixer == "mamba":
            add("bf16_ops", 2 * t * d * 2 * di + 2 * t * di * d)
            add("f32_ops", 2 * k_conv * t * di + 2 * t * di * (r + 2 * n_st)
                + 2 * t * r * di + 8 * t * di * n_st)
            add("bytes", rw * batch * ((k_conv - 1) * di * 2
                                       + di * n_st * 4))
        elif mixer == "rwkv":
            c = _fit(seq, 16)
            add("bf16_ops", 10 * t * d * d)
            add("f32_ops", 4 * t * d * 64 + t * d * (4 * c + 4 * hd),
                4 * t * d * 64 + t * d * (5 * cfg.rwkv_head_dim + 4))
            add("bytes", rw * batch * (2 * d + 4 * d * cfg.rwkv_head_dim))
        if cfg.is_encdec:
            kv_proj = (0 if cache_len
                       else 4 * batch * cfg.encoder_seq * d * nh * hd)
            pairs = t * cfg.encoder_seq
            add("bf16_ops", 4 * t * d * nh * hd + kv_proj,
                4 * t * d * nh * hd + kv_proj + qk_pv * pairs)
            add("f32_ops", qk_pv * pairs, 0)
            add("bytes", 2 * batch * cfg.encoder_seq * nh * hd * 2)
        if ffn == "mlp":
            add("bf16_ops", 6 * t * d * f)
        elif ffn == "cmix":
            add("bf16_ops", 4 * t * d * f + 2 * t * d * d)
            add("bytes", rw * batch * d * 2)
        elif ffn == "moe":
            e, fe, k = cfg.n_experts, cfg.expert_ff, cfg.experts_per_token
            groups = cfg.moe_groups if t % cfg.moe_groups == 0 else 1
            slots = e * capacity(cfg, t // groups) * groups
            add("bf16_ops", 3 * 2 * slots * d * fe, 3 * 2 * t * k * d * fe)
            add("f32_ops", 2 * t * d * e)
            n_moe += 1
    if cfg.is_encdec and not cache_len:
        te = batch * cfg.encoder_seq
        pairs = batch * cfg.encoder_seq ** 2
        enc = (2 * te * d * (nh + 2 * kv) * hd + 2 * te * nh * hd * d
               + 6 * te * d * f)
        add("bf16_ops", cfg.encoder_layers * enc,
            cfg.encoder_layers * (enc + qk_pv * pairs))
        add("f32_ops", cfg.encoder_layers * qk_pv * pairs, 0)
        add("bytes", 4 * te * d)
    add("bf16_ops", 2 * batch * d * v)
    rows = 4 * min(t, v) * d + (4 * t * d if cfg.is_encdec else 0)
    add("bytes", weight_bytes + rows + 2 * batch * v)
    if n_moe and experts_read is not None:
        unread = n_moe * cfg.n_experts - experts_read
        work["function"]["bytes"] -= unread * 3 * d * cfg.expert_ff * 4
    return work


def recorded_route(picks: list):
    """``moe.route`` that also appends each call's expert indices to
    ``picks``; calls come layer by layer, token groups in token order."""
    from repro_torch.models import moe
    route = moe.route

    def recording(xt, p, cfg, router_bits=None):
        top_w, top_i = route(xt, p, cfg, router_bits)
        picks.append(top_i)
        return top_w, top_i
    return recording


def lm_bound_ms(work: dict, bw: float, peaks: tuple) -> tuple[float, str]:
    """The least time for ``work``: the larger of its bytes over the memory
    rate and its operations over the peak rate of their type."""
    t_bytes = work["bytes"] / bw
    t_ops = work["bf16_ops"] / peaks[0] + work["f32_ops"] / peaks[1]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def peak_flops(name: str) -> tuple:
    for key, bf16, f32 in PEAK_FLOPS:
        if key in name:
            return bf16, f32
    raise RuntimeError(f"no peak-rate entry for card {name!r}")


def event_ms(fn):
    """``fn()`` between two CUDA events; returns (result, milliseconds)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def lm_consistency(params, cfg, toks, dtype, **kw):
    """``prefill`` of ``toks[:, :-1]`` then ``decode_step`` of the last
    token, against ``forward(toks)[:, -1]``, with ``dtype`` as the compute
    dtype (``kw``: an encoder-decoder's ``frames``).  Prefill and decode
    take the experts that ``forward`` chose for the same token in the same
    layer, weighted by their own gates (a model without MoE layers has
    nothing to replay): at 128
    experts top-8 the 8th and 9th gates often lie closer than bf16 rounding
    moves them, and one flipped expert moves the logits by more than any
    tolerance.  With the choices fixed, everything else on the path
    (attention over the ring caches, the gate weights, the experts, the
    logits) answers to the tolerance on every sequence.  Returns (decode
    logits, forward logits, and per stage the number of (token, layer)
    pairs whose own top-k differs from forward's)."""
    from unittest import mock

    import torch

    from repro_torch.models import (decode_step, forward, init_cache, lm,
                                    moe, prefill)
    b, s = toks.shape[0], toks.shape[1] - 1
    n = sum(kind.endswith("+moe") for kind in cfg.pattern) * cfg.n_repeat
    k = cfg.experts_per_token
    route = moe.route
    chosen = []

    def replaying(xt, p, c, router_bits=None):
        nonlocal cursor, n_flip
        top_i = queue[cursor:cursor + xt.shape[0]]
        cursor += xt.shape[0]
        own = route(xt, p, c, router_bits)[1]
        n_flip += int((own.sort(-1).values != top_i.sort(-1).values)
                      .any(-1).sum())
        gates = torch.softmax(xt.float() @ p["w_router"].float(), dim=-1)
        top_w = gates.gather(1, top_i)
        top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
        return top_w, top_i

    flips = {}
    with mock.patch.object(lm, "COMPUTE_DTYPE", dtype):
        with mock.patch.object(moe, "route", recorded_route(chosen)):
            want = forward(params, cfg, toks, **kw)[:, -1].float()
        caches = init_cache(cfg, b, s + 8, dtype=dtype, device=toks.device)
        if not n:                       # no MoE layer: nothing to replay
            prefill(params, cfg, toks[:, :-1], caches, **kw)
            got = decode_step(params, cfg, toks[:, -1:], caches, s)[0][:, 0]
            return got.float(), want, {"prefill": 0, "decode": 0}
        fwd = torch.cat(chosen).reshape(n, b, s + 1, k)
        with mock.patch.object(moe, "route", replaying):
            queue, cursor, n_flip = fwd[:, :, :s].reshape(-1, k), 0, 0
            prefill(params, cfg, toks[:, :-1], caches, **kw)
            check(cursor == queue.shape[0], "prefill took forward's experts")
            flips["prefill"] = n_flip
            queue, cursor, n_flip = fwd[:, :, s].reshape(-1, k), 0, 0
            got = decode_step(params, cfg, toks[:, -1:], caches, s)[0][:, 0]
            check(cursor == queue.shape[0], "decode took forward's experts")
            flips["decode"] = n_flip
    return got.float(), want, flips


def lm_phase(dev, name: str, bw: float) -> dict:
    """Phase 9: the LM serving path of ``LM_ARCH`` at its published widths,
    cut to ``LM_LAYERS`` layers, on the card: init, prefill -> decode
    against ``forward``, a timed prefill and greedy decode beside their
    bounds, one MoE layer against the dense per-expert computation, and
    layer 0's softmax router distilled into a CART tree routed by
    ``route_tcam``.  Returns the phase's record."""
    import dataclasses
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import predict, train_tree
    from repro_torch.data import make_batch
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    lm, moe, param_count, prefill)
    from repro_torch.models.tcam_router import compile_router, route_tcam

    t_phase = time.perf_counter()
    zero_counts()
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=LM_LAYERS)
    kind = cfg.pattern[0]
    check(kind == "attn+moe" and len(cfg.pattern) == 1,
          f"{LM_ARCH} is one attention + MoE block kind")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 products run in f32, not TF32")
    log(f"lm: {cfg.name} reduced: n_layers {full.n_layers} -> "
        f"{cfg.n_layers}; every width as published (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv x {cfg.head_dim}, "
        f"{cfg.n_experts} experts top-{cfg.experts_per_token} x "
        f"{cfg.expert_ff}, vocab {cfg.vocab_size}); memory before: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    # -- init on the card ---------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    params, t_init = sync_time(lambda: init_params(cfg, LM_SEED, device=dev))
    leaves = [*(v for k, v in params.items() if k != "blocks"),
              *params["blocks"][kind].values()]
    n_params = param_count(params)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    norms = cfg.n_layers * (2 * cfg.d_model + 2 * cfg.head_dim) + cfg.d_model
    check(all(t.device.type == dev.type and t.dtype == torch.float32
              for t in leaves), "params are f32 on the card")
    check(n_params == cfg.n_params() + norms,
          f"param count {n_params} == the config's {cfg.n_params()} + norms")
    log(f"lm init: {n_params} params, {w_bytes / 1e9:.2f} GB f32, "
        f"{t_init:.2f} s, max allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # -- prefill -> decode against forward --------------------------------------
    ccfg = dataclasses.replace(cfg, capacity_factor=LM_CHECK_CF)
    toks = torch.from_numpy(make_batch(ccfg, LM_CHECK_BATCH, LM_CHECK_SEQ + 1,
                                       seed=LM_SEED)["tokens"]).to(dev)
    consistency = {}
    for dtype in (torch.float32, torch.bfloat16):
        got, want, flips = lm_consistency(params, ccfg, toks, dtype)
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              f"{dtype}: prefill/decode and forward logits are finite")
        err = (got - want).abs().amax(dim=-1).tolist()
        check(torch.allclose(got, want, rtol=LM_CHECK_TOL, atol=LM_CHECK_TOL),
              f"{dtype}: with forward's experts, prefill -> decode equals "
              f"forward within {LM_CHECK_TOL} on every sequence (max abs "
              f"err by sequence {err})")
        consistency[str(dtype).split(".")[-1]] = rec = {
            "max_abs_err_by_seq": err, "own_topk_differs": flips}
        log(json.dumps({"lm_prefill_decode_vs_forward": {
            "dtype": str(dtype), "batch": LM_CHECK_BATCH,
            "prompt": LM_CHECK_SEQ, "cf": LM_CHECK_CF, **rec}}))
    check(consistency["float32"]["own_topk_differs"]["decode"] == 0,
          "in f32 compute decode's own router picks forward's experts")
    del toks

    # -- timed prefill and greedy decode ------------------------------------
    toks = torch.from_numpy(make_batch(cfg, LM_BATCH, LM_PROMPT, step=1,
                                       seed=LM_SEED)["tokens"]).to(dev)
    caches = init_cache(cfg, LM_BATCH, LM_PROMPT + LM_DECODE, device=dev)
    prefill(params, cfg, toks, caches)          # warm-up, same shapes
    (logits, caches), prefill_ms = event_ms(
        lambda: prefill(params, cfg, toks, caches))
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    step_ms = []
    for i in range(LM_DECODE):
        last = tok
        (logits, caches), ms = event_ms(
            lambda: decode_step(params, cfg, tok, caches, LM_PROMPT + i))
        step_ms.append(ms)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
    check(bool(finite), "every prefill and decode logit is finite")
    check(bool((caches[kind]["slot_pos"][:, :LM_PROMPT + LM_DECODE]
                == torch.arange(LM_PROMPT + LM_DECODE, device=dev)).all()),
          "the caches hold every prompt and decoded position")
    # the experts the last step's tokens chose, from a rerun of that step
    # (it writes the same keys and values to the same cache slot)
    picks = []
    with mock.patch.object(moe, "route", recorded_route(picks)):
        decode_step(params, cfg, last, caches, LM_PROMPT + LM_DECODE - 1)
    experts_read = sum(int(torch.unique(r).numel())
                       for r in torch.cat(picks).reshape(cfg.n_layers, -1))
    peaks = peak_flops(name)
    no_embed = w_bytes - params["embed"].numel() * 4
    pre_work = lm_work(cfg, no_embed, LM_BATCH, LM_PROMPT)
    dec_work = lm_work(cfg, no_embed, LM_BATCH, 1, LM_PROMPT + LM_DECODE,
                       experts_read)
    bounds = {f"{stage}_{what}": lm_bound_ms(work[what], bw, peaks)
              for stage, work in (("prefill", pre_work), ("decode", dec_work))
              for what in ("reference", "function")}
    tokens = LM_BATCH * LM_PROMPT
    serve = {
        "batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": LM_DECODE,
        "prefill_ms": prefill_ms, "prefill_tokens_per_s":
            tokens / prefill_ms * 1e3,
        "prefill_bound_tokens_per_s":
            tokens / bounds["prefill_reference"][0] * 1e3,
        "prefill_work": pre_work,
        "decode_ms_per_step_median": statistics.median(step_ms),
        "decode_ms_per_step_mean": statistics.mean(step_ms),
        "decode_ms_first_step": step_ms[0],
        "decode_experts_read": experts_read,
        "decode_work": dec_work,
        "bound_ms_by": bounds,
        "peak_rates": {"bytes_per_s": bw, "bf16_ops_per_s": peaks[0],
                       "f32_ops_per_s": peaks[1]},
        "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(json.dumps({"lm_serve": serve}))
    del logits, caches, tok, last

    # -- one MoE layer against the dense per-expert computation -------------
    p0 = {k: v[0] for k, v in params["blocks"][kind].items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    x = torch.randn((1, LM_MOE_TOKENS, cfg.d_model), generator=gen,
                    device=dev)                    # f32: no bf16 rounding
    y = moe.moe_ffn(x, p0, cfg)
    xt = x.reshape(-1, cfg.d_model)
    top_w, top_i = moe.route(xt, p0, cfg)
    gates = torch.softmax(xt @ p0["w_router"], dim=-1)
    w_ref, i_ref = torch.topk(gates, cfg.experts_per_token, dim=-1)
    check(torch.equal(top_i, i_ref), "the layer's experts equal top-k")
    g = cfg.moe_groups if LM_MOE_TOKENS % cfg.moe_groups == 0 else 1
    c = moe.capacity(cfg, LM_MOE_TOKENS // g)
    ranks = torch.cat([moe._positions_in_expert(grp.reshape(-1),
                                                cfg.n_experts)
                       for grp in top_i.reshape(g, -1, top_i.shape[1])])
    check(bool((ranks < c).all()), "no capacity drops on the MoE check")
    w_ref = w_ref / w_ref.sum(-1, keepdim=True)
    dense = torch.stack([
        (torch.nn.functional.silu(xt @ p0["w_gate"][e]) * (xt @ p0["w_up"][e]))
        @ p0["w_down"][e] for e in range(cfg.n_experts)], 1)
    want = torch.einsum("tk,tkd->td", w_ref,
                        torch.take_along_dim(dense, i_ref[..., None], 1))
    moe_err = float((y.reshape(-1, cfg.d_model) - want).abs().max())
    check(torch.allclose(y.reshape(-1, cfg.d_model), want, rtol=LM_MOE_TOL,
                         atol=LM_MOE_TOL),
          f"MoE layer equals the dense per-expert reference (err {moe_err})")
    log(f"lm moe layer: {LM_MOE_TOKENS} tokens, {g} groups of capacity {c}, "
        f"max abs err vs dense per-expert {moe_err:.3g} (tol {LM_MOE_TOL})")
    del x, y, xt, dense, want, gates

    # -- layer 0's softmax router distilled into a TCAM tree ----------------
    sin, cos = lm._rope_tables(cfg, torch.arange(LM_PROMPT, device=dev))
    ctx = lm.Ctx(mode="full", sin=sin, cos=cos)
    with torch.no_grad():
        h = lm._attention_mixer(kind, lm._embed(params, cfg, toks), p0, cfg,
                                ctx, None)
        xn = lm._norm(h, p0["norm2"], cfg)        # what layer 0's router sees
    xt = xn.reshape(-1, cfg.d_model)
    teacher = moe.route(xt, p0, cfg)[1][:, 0].cpu().numpy()
    feats = xt[:, :LM_ROUTER_FEATURES].float().cpu().numpy()
    t0 = time.perf_counter()
    tree = train_tree(feats, teacher, max_depth=LM_ROUTER_DEPTH,
                      max_leaves=LM_ROUTER_LEAVES)
    t_fit = time.perf_counter() - t0
    bits = compile_router(tree, device=dev)
    routed, route_ms = event_ms(lambda: route_tcam(xt, bits))
    golden = predict(tree, feats)
    routed = routed.cpu().numpy()
    check(np.array_equal(routed, golden),
          "route_tcam on the card equals the tree on every token")
    tcfg = dataclasses.replace(cfg, router="tcam_dt")
    y = moe.moe_ffn(xn, p0, tcfg, router_bits=bits)
    check(y.shape == xn.shape and y.dtype == xn.dtype
          and bool(torch.isfinite(y).all()),
          "moe_ffn(router='tcam_dt') output is finite, of the input's shape")
    router = {
        "tokens": int(xt.shape[0]), "features": LM_ROUTER_FEATURES,
        "tree_leaves": int(tree.n_leaves), "fit_s": t_fit,
        "lut_rows": int(bits["is0"].shape[0]),
        "lut_bits": int(bits["is0"].shape[1]), "route_ms": route_ms,
        "equal_to_tree": True,
        "agreement_with_teacher_top1": float((routed == teacher).mean()),
    }
    log(json.dumps({"lm_router": router}))
    del params, toks, h, xn, xt, y, p0, bits

    counts = read_counts()
    log(f"phase 9 launches: {counts}")
    check(not any(counts.values()), "the LM path launches no match kernel")
    seconds = time.perf_counter() - t_phase
    log(f"phase 9: {seconds:.1f} s")
    return {"serve": serve, "router": router, "consistency": consistency,
            "moe_err": moe_err, "seconds": seconds}


def outside_n_params(cfg) -> int:
    """The parameters that ``ModelConfig.n_params`` leaves out: every norm
    scale (qk-norm's too), mamba's conv and dt biases, rwkv's token-shift
    mixes and group norm, the channel mix's mixes, and an encoder-decoder's
    cross-attention norm, encoder norms, the third matrix of each encoder
    layer's gated MLP (``n_params`` counts 2*d*F there) and both
    positional tables (the decoder's has 32768 rows)."""
    d = cfg.d_model
    out = d                                           # final_norm
    for kind in cfg.pattern * cfg.n_repeat:
        mixer, ffn = kind.split("+")
        out += d + d                                  # norm1, norm2
        if mixer in ("attn", "swa") and cfg.qk_norm:
            out += 2 * cfg.head_dim
        elif mixer == "mamba":
            out += 2 * cfg.d_inner
        elif mixer == "rwkv":
            out += 5 * d + d
        if ffn == "cmix":
            out += 2 * d
        if cfg.is_encdec:
            out += d                                  # norm_x
    if cfg.is_encdec:
        out += cfg.encoder_layers * (2 * d + d * cfg.d_ff) + d
        out += (cfg.encoder_seq + 32768) * d
    return out


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def stepwise_check(params, cfg, dev) -> dict | None:
    """Layer 0 of the config's recurrent mixer at full width, f32: the
    chunked form over 2*CHUNK tokens against the token recurrence (the
    output and the final state), at the JAX package's tolerances."""
    import torch

    from repro_torch.models import mamba, rwkv
    kinds = [k for k in cfg.kinds if k.split("+")[0] in ("mamba", "rwkv")]
    if not kinds:
        return None
    kind = kinds[0]
    p0 = {k: v[0] for k, v in params["blocks"][kind].items()}
    if kind.startswith("mamba"):
        mod, scale, tol = mamba, 1.0, LM_STEP_TOL["mamba"]
        mixer = mamba.mamba_mixer
        state = mamba.init_mamba_state(cfg, 2, torch.float32, device=dev)
    else:
        mod, scale, tol = rwkv, 0.5, LM_STEP_TOL["rwkv"]
        mixer = rwkv.rwkv_mixer
        state = rwkv.init_rwkv_state(cfg, 2, torch.float32, device=dev)[:2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    x = scale * torch.randn((2, 2 * mod.CHUNK, cfg.d_model), generator=gen,
                            device=dev)
    with torch.no_grad():
        full, (_, s_full) = mixer(x, p0, cfg, return_state=True)
        outs = []
        for t in range(x.shape[1]):
            o, state = mixer(x[:, t:t + 1], p0, cfg, state=state,
                             return_state=True)
            outs.append(o)
    step = torch.cat(outs, dim=1)
    rec = {"kind": kind, "tokens": x.shape[1], "tol": tol,
           "max_abs_err": float((full - step).abs().max()),
           "state_max_abs_err": float((s_full - state[1]).abs().max())}
    check(torch.allclose(full, step, rtol=tol, atol=tol)
          and torch.allclose(s_full, state[1], rtol=tol, atol=tol),
          f"{kind} layer 0: chunked equals stepwise within {tol} ({rec})")
    return rec


def lm_family(dev, name: str, bw: float, arch: str, layers, prompt: int,
              peaks: tuple) -> dict:
    """One configuration of phase 10: init on the card, prefill -> decode
    against ``forward`` in f32 and bf16, chunked against stepwise at full
    width, and a timed prefill and greedy decode beside their bounds."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import (decode_step, encode_audio, init_cache,
                                    init_params, moe, param_count, prefill)

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    enc = f" (+{cfg.encoder_layers} encoder)" if cfg.is_encdec else ""
    log(f"lm {arch}: layers {cfg.n_layers} of {full.n_layers}{enc}"
        f", every width as published (d_model {cfg.d_model}, pattern "
        f"{list(cfg.pattern)}, vocab {cfg.vocab_size}); memory before: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = sync_time(lambda: init_params(cfg, LM_SEED, device=dev))
    n_params = param_count(params)
    w_bytes = tree_bytes(params)
    check(n_params == cfg.n_params() + outside_n_params(cfg),
          f"{arch}: param count {n_params} == the config's {cfg.n_params()}"
          f" + {outside_n_params(cfg)} it leaves out")
    init = {"params": n_params, "GB": w_bytes / 1e9, "s": t_init,
            "max_allocated_GB": torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps({"lm_family_init": {"arch": arch, **init}}))

    def inputs(batch, seq, step):
        b = make_batch(cfg, batch, seq, step=step, seed=LM_SEED)
        kw = ({"frames": torch.from_numpy(b["frames"]).to(dev)}
              if cfg.is_encdec else {})
        return torch.from_numpy(b["tokens"]).to(dev), kw

    # -- prefill -> decode against forward, f32 and bf16 -------------------
    ccfg = (dataclasses.replace(cfg, capacity_factor=LM_CHECK_CF)
            if cfg.n_experts else cfg)
    toks, kw = inputs(LM_CHECK_BATCH, LM_CHECK_SEQ + 1, 0)
    consistency, forward_last = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        got, want, flips = lm_consistency(params, ccfg, toks, dtype, **kw)
        name_dt = str(dtype).split(".")[-1]
        forward_last[name_dt] = want
        # bf16 is held to 5e-2, or to bf16's own reach on this model where
        # that is larger: how far forward's bf16 logits lie from its f32
        # ones on the same tokens (24 random rwkv layers carry a last-ulp
        # difference a long way, in the JAX package too)
        band = (float((want - forward_last["float32"]).abs().max())
                if dtype == torch.bfloat16 else 0.0)
        tol = max(LM_CHECK_TOL, band)
        err = (got - want).abs().amax(dim=-1).tolist()
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all())
              and torch.allclose(got, want, rtol=tol, atol=tol),
              f"{arch} {dtype}: prefill -> decode equals forward within "
              f"{tol} (max abs err by sequence {err}, own top-k "
              f"differing {flips})")
        consistency[name_dt] = {"max_abs_err_by_seq": err, "tol": tol,
                                "forward_bf16_vs_f32": band,
                                "own_topk_differs": flips}
    check(not any(consistency["float32"]["own_topk_differs"].values()),
          f"{arch}: in f32 compute every token is routed as forward routes it")
    log(json.dumps({"lm_family_prefill_decode_vs_forward": {
        "arch": arch, "batch": LM_CHECK_BATCH, "prompt": LM_CHECK_SEQ,
        "cf": ccfg.capacity_factor if cfg.n_experts else None,
        **consistency}}))
    del toks, kw

    stepwise = stepwise_check(params, cfg, dev)
    if stepwise:
        log(json.dumps({"lm_family_chunked_vs_stepwise": {"arch": arch,
                                                          **stepwise}}))

    # -- timed prefill and greedy decode ------------------------------------
    toks, kw = inputs(LM_BATCH, prompt, 1)
    caches = init_cache(cfg, LM_BATCH, prompt + LM_DECODE, device=dev)
    prefill(params, cfg, toks, caches, **kw)           # warm-up, same shapes
    caches = init_cache(cfg, LM_BATCH, prompt + LM_DECODE, device=dev)
    encode_ms = None
    if cfg.is_encdec:
        _, encode_ms = event_ms(lambda: encode_audio(params, cfg,
                                                     kw["frames"]))
    (logits, caches), prefill_ms = event_ms(
        lambda: prefill(params, cfg, toks, caches, **kw))
    finite = torch.isfinite(logits).all()
    for kind, leaves in caches.items():
        for leaf in ("h", "S", "conv", "xa", "xc", "xk", "xv"):
            if leaf in leaves:
                check(bool(leaves[leaf].abs().amax() > 0),
                      f"{arch}: prefill wrote the {kind} cache's {leaf}")
    tok = logits.argmax(-1)
    step_ms = []
    for i in range(LM_DECODE):
        last = tok
        (logits, caches), ms = event_ms(
            lambda: decode_step(params, cfg, tok, caches, prompt + i))
        step_ms.append(ms)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
    check(bool(finite), f"{arch}: every prefill and decode logit is finite")
    for kind, leaves in caches.items():
        if "slot_pos" in leaves:
            check(bool((leaves["slot_pos"][:, :prompt + LM_DECODE]
                        == torch.arange(prompt + LM_DECODE, device=dev)
                        ).all()),
                  f"{arch}: the {kind} caches hold every position")
    experts_read = None
    if cfg.n_experts:
        # the experts the last step's tokens chose, from a rerun of that
        # step on a copy of the caches it read (the recurrent states move)
        picks = []
        snap = {k: {n: t.clone() for n, t in c.items()}
                for k, c in caches.items()}
        with mock.patch.object(moe, "route", recorded_route(picks)):
            decode_step(params, cfg, last, snap, prompt + LM_DECODE - 1)
        n_moe = sum(k.endswith("+moe") for k in cfg.pattern) * cfg.n_repeat
        experts_read = sum(int(torch.unique(r).numel())
                           for r in torch.cat(picks).reshape(n_moe, -1))
        del snap
    embed = params["embed"].numel() * 4
    pos = params["dec_pos_emb"].numel() * 4 if cfg.is_encdec else 0
    read_pre = w_bytes - (0 if cfg.tie_embeddings else embed) - pos
    read_dec = read_pre - (tree_bytes(params["encoder"]) if cfg.is_encdec
                           else 0)
    pre_work = lm_work(cfg, read_pre, LM_BATCH, prompt)
    dec_work = lm_work(cfg, read_dec, LM_BATCH, 1, prompt + LM_DECODE,
                       experts_read)
    bounds = {f"{stage}_{what}": lm_bound_ms(work[what], bw, peaks)
              for stage, work in (("prefill", pre_work), ("decode", dec_work))
              for what in ("reference", "function")}
    tokens = LM_BATCH * prompt
    serve = {
        "arch": arch, "layers": cfg.n_layers, "batch": LM_BATCH,
        "prompt": prompt, "decode_steps": LM_DECODE,
        "encode_ms": encode_ms, "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": tokens / prefill_ms * 1e3,
        "prefill_work": pre_work,
        "decode_ms_per_step_median": statistics.median(step_ms),
        "decode_ms_per_step_mean": statistics.mean(step_ms),
        "decode_ms_first_step": step_ms[0],
        "decode_experts_read": experts_read, "decode_work": dec_work,
        "bound_ms_by": bounds,
        "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(json.dumps({"lm_family_serve": serve}))
    seconds = time.perf_counter() - t0
    log(f"lm {arch}: {seconds:.1f} s")
    return {"init": init, "consistency": consistency, "stepwise": stepwise,
            "serve": serve, "seconds": seconds}


def lm_families_phase(dev, name: str, bw: float) -> dict:
    """Phase 10: the LM serving path of the recurrent and encoder-decoder
    families (``LM_FAMILIES``) at their published widths on the card, one
    configuration at a time, each freed before the next."""
    import torch

    t_phase = time.perf_counter()
    zero_counts()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 products run in f32, not TF32")
    peaks = peak_flops(name)
    out = {}
    for arch, (layers, prompt) in LM_FAMILIES.items():
        out[arch] = lm_family(dev, name, bw, arch, layers, prompt, peaks)
        gc.collect()
        torch.cuda.empty_cache()
    counts = read_counts()
    log(f"phase 10 launches: {counts}")
    check(not any(counts.values()), "the LM path launches no match kernel")
    seconds = time.perf_counter() - t_phase
    log(f"phase 10: {seconds:.1f} s")
    out["seconds"] = seconds
    return out


def train_work(cfg, batch: int, seq: int, n_params: int, remat: str) -> dict:
    """What one train step of ``batch`` x ``seq`` tokens does, from
    ``lm_work``'s count of a prefill (its head widened to every token, as
    the loss needs): operations three times the forward's (the forward and
    a backward of twice it), plus one forward more for ``remat="full"`` in
    the ``"reference"`` count (the recomputed repeats); bytes the state
    that the update reads and writes, 28 per param (param, first and second
    moment read and written, gradient read; f32)."""
    fwd = lm_work(cfg, 0, batch, seq)
    head = 2 * (batch * seq - batch) * cfg.d_model * cfg.vocab_size
    out = {}
    for what, w in fwd.items():
        mult = 3 + (1 if remat == "full" and what == "reference" else 0)
        out[what] = {"bf16_ops": mult * (w["bf16_ops"] + head),
                     "f32_ops": mult * w["f32_ops"],
                     "bytes": 28 * n_params}
    return out


def grads_close(got: dict, want: dict, tol: float) -> float:
    """The largest distance of a gradient leaf of ``got`` from ``want``'s,
    as a fraction of that leaf's largest |g| (a leaf that is zero in
    ``want`` must be zero in ``got``); raises past ``tol``."""
    from repro_torch.pytree import tree_leaves
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.float().cpu(), b.float().cpu()
        top = float(b.abs().max())
        err = float((a - b).abs().max())
        if top == 0.0:
            check(err == 0.0, "a gradient leaf that is zero stays zero")
            continue
        worst = max(worst, err / top)
    check(worst <= tol, f"every gradient leaf within {tol} of its largest "
          f"|g| (worst {worst:.3g})")
    return worst


def train_checks(dev, cfg, opt) -> dict:
    """Phase 11's checks at full width on ``TRAIN_CUT_LAYERS`` layers:
    the card against the CPU (loss, every gradient leaf, one AdamW update
    on the same gradients), the remat modes, accum 2 against accum 1,
    checkpoint and restore bit for bit, the fault-tolerant loop, and one
    compressed step.  Returns the record."""
    import dataclasses
    import tempfile
    from unittest import mock

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params, lm
    from repro_torch.optim import adamw_init, adamw_update, quantize_int8
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.runtime import FaultTolerantLoop
    from repro_torch.train import (accumulate_grads, build_train_step,
                                   init_train_state)

    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    cpu = torch.device("cpu")
    (ROOT / "build").mkdir(exist_ok=True)      # the checkpoints' scratch
    pipe = TokenPipeline(cut, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ, seed=LM_SEED)
    batch = pipe.batch_at(0)
    on = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    rec = {"layers": cut.n_layers, "batch": TRAIN_CUT_BATCH,
           "seq": TRAIN_CUT_SEQ}
    params = init_params(cut, LM_SEED, device=dev)
    with mock.patch.object(lm, "COMPUTE_DTYPE", torch.float32):
        # -- the card against the CPU, f32 compute --------------------------
        g_card, m_card = accumulate_grads(cut, params, on, remat="full")
        p_cpu = tree_map(lambda t: t.to(cpu), params)
        g_cpu, m_cpu = accumulate_grads(cut, p_cpu, batch, remat="full")
        lc, lh = float(m_card["loss"]), float(m_cpu["loss"])
        check(abs(lc - lh) <= TRAIN_LOSS_RTOL * abs(lh),
              f"loss on the card {lc} equals the CPU's {lh} within "
              f"{TRAIN_LOSS_RTOL}")
        rec["card_vs_cpu"] = {"loss": lc, "loss_cpu": lh,
                              "grad_worst": grads_close(g_card, g_cpu,
                                                        TRAIN_GRAD_TOL)}
        # one update on the same gradients, on both sides
        g_same = tree_map(lambda t: t.to(cpu), g_card)
        pc, sc, mc = adamw_update(g_card, adamw_init(params, opt), params, opt)
        ph, sh, mh = adamw_update(g_same, adamw_init(p_cpu, opt), p_cpu, opt)
        worst = 0.0
        for a, b in zip(tree_leaves((pc, sc.mu, sc.nu)),
                        tree_leaves((ph, sh.mu, sh.nu))):
            a = a.cpu()
            check(torch.allclose(a, b, **TRAIN_UPDATE_TOL),
                  f"adamw_update on the card equals the CPU's within "
                  f"{TRAIN_UPDATE_TOL}")
            worst = max(worst, float((a - b).abs().max()))
        rec["update_card_vs_cpu_max_abs"] = worst
        del g_cpu, p_cpu, g_same, pc, sc, ph, sh
        # -- remat modes and accumulation on the card, f32 -------------------
        remats = {}
        for remat in ("none", "dots"):
            g, m = accumulate_grads(cut, params, on, remat=remat)
            check(abs(float(m["loss"]) - lc) <= TRAIN_REMAT_TOL * abs(lc),
                  f"remat {remat}: the loss of remat full")
            remats[remat] = grads_close(g, g_card, TRAIN_REMAT_TOL)
        rec["remat_grad_worst"] = remats
        g2, m2 = accumulate_grads(cut, params, on, accum=2, remat="full")
        rec["accum2_vs_1"] = {"loss": float(m2["loss"]),
                              "grad_worst": grads_close(g2, g_card,
                                                        TRAIN_GRAD_TOL)}
        del g2, g_card
    # -- checkpoint and restore, bit for bit (bf16 compute, as trained) -----
    step = build_train_step(cut, opt)
    state = init_train_state(cut, LM_SEED, opt_cfg=opt, device=dev)
    for s in range(3):
        state, _ = step(state, pipe.batch_at(s))
    # the embedding's and the gather's backward add with float atomics on
    # the card, so two runs may differ in the last bit: the restart check
    # runs with PyTorch's deterministic algorithms
    a1, _ = step(state, pipe.batch_at(3))
    a2, _ = step(state, pipe.batch_at(3))
    rec["restart_equal_without_deterministic"] = all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a1), tree_leaves(a2)))
    del a1, a2
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            mgr = CheckpointManager(d)
            t0 = time.perf_counter()
            mgr.save(3, state)
            rec["save_s"] = time.perf_counter() - t0
            want, wm = step(state, pipe.batch_at(3))
            fresh = init_train_state(cut, LM_SEED + 1, opt_cfg=opt,
                                     device=dev)
            t0 = time.perf_counter()
            restored, at = mgr.restore(fresh)
            rec["restore_s"] = time.perf_counter() - t0
            check(at == 3 and int(restored.opt.step) == 3,
                  "restored the checkpoint of step 3")
            got, gm = step(restored, pipe.batch_at(3))
        check(all(torch.equal(x, y) for x, y in zip(tree_leaves(got),
                                                    tree_leaves(want)))
              and all(torch.equal(gm[k], wm[k]) for k in wm),
              "step 4 after the restore equals the uninterrupted step 4 "
              "bit for bit")
    finally:
        torch.use_deterministic_algorithms(False)
    rec["checkpoint_GB"] = sum(t.numel() * t.element_size()
                               for t in tree_leaves(state)) / 1e9
    del state, want, got, restored, fresh
    # -- the fault-tolerant loop ---------------------------------------------
    logs, calls = [], {"n": 0}

    def flaky(st, b):
        calls["n"] += 1
        if calls["n"] == 7:
            raise RuntimeError("injected failure")
        return step(st, b)

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        loop = FaultTolerantLoop(flaky, pipe.batch_at, CheckpointManager(d),
                                 ckpt_every=5, max_retries=2)
        t0 = time.perf_counter()
        state, end, hist = loop.run(
            init_train_state(cut, LM_SEED, opt_cfg=opt, device=dev), 0, 12,
            log_every=0, log=logs.append)
        rec["fault_loop_s"] = time.perf_counter() - t0
    check(end == 12 and int(state.opt.step) == 12,
          f"the fault loop reached step 12 ({end})")
    check(all(math.isfinite(h["loss"]) for h in hist),
          "every loss of the fault loop is finite")
    check("[fault] restored checkpoint at step 5" in logs,
          f"the loop restored step 5 after the failure ({logs})")
    rec["fault_loop"] = {"end": end, "log": logs,
                         "losses": [h["loss"] for h in hist]}
    del state
    # -- one compressed step --------------------------------------------------
    state = init_train_state(cut, LM_SEED, compress=True, opt_cfg=opt,
                             device=dev)
    grads, _ = accumulate_grads(cut, state.params, on)
    qmax = max(int(quantize_int8(g)[0].abs().max())
               for g in tree_leaves(grads))
    check(all(quantize_int8(g)[0].dtype == torch.int8
              for g in tree_leaves(grads)) and qmax <= 127,
          f"q is int8 within +-127 ({qmax})")
    state, m = build_train_step(cut, opt, compress=True)(state, batch)
    check(math.isfinite(float(m["loss"]))
          and all(bool(torch.isfinite(r).all())
                  for r in tree_leaves(state.ef)),
          "the compressed step's loss and EF residual are finite")
    rec["compressed"] = {"loss": float(m["loss"]), "q_max": qmax,
                         "ef_max": max(float(r.abs().max())
                                       for r in tree_leaves(state.ef))}
    return rec


def train_family(dev, arch: str, seq: int, bw: float, peaks: tuple) -> dict:
    """One timed train step of ``arch`` whole at every published width, at
    ``TRAIN_BATCH`` x ``seq`` tokens (after one untimed step): finite loss
    and gradients, step ms beside its bound, peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import param_count
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.train import build_train_step, init_train_state

    cfg = get_config(arch)
    opt = AdamWConfig(**TRAIN_OPT)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, LM_SEED, opt_cfg=opt, device=dev)
    n_params = param_count(state.params)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, seq, seed=LM_SEED)
    step = build_train_step(cfg, opt, remat=TRAIN_REMAT)
    state, _ = step(state, pipe.batch_at(0))
    (state, m), ms = event_ms(lambda: step(state, pipe.batch_at(1)))
    check(math.isfinite(float(m["loss"])) and math.isfinite(
        float(m["grad_norm"])) and math.isfinite(float(global_norm(
            state.params))), f"{arch}: finite loss, gradients and params")
    work = train_work(cfg, TRAIN_BATCH, seq, n_params, TRAIN_REMAT)
    rec = {"arch": arch, "layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers if cfg.is_encdec else 0,
           "params": n_params, "batch": TRAIN_BATCH, "seq": seq,
           "step_ms": ms, "tokens_per_s": TRAIN_BATCH * seq / ms * 1e3,
           "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "work": work,
           "bound_ms_by": {w: lm_bound_ms(work[w], bw, peaks)
                           for w in work},
           "max_memory_allocated_GB":
               torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps({"train_family": rec}))
    return rec


def train_phase(dev, name: str, bw: float) -> dict:
    """Phase 11: the trainer at ``TRAIN_ARCH``'s full width and depth on the
    card, then one step of each of ``TRAIN_FAMILIES``; the match kernels'
    counters are zeroed before and read after (training launches none).
    Returns the phase's record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import forward, loss_fn, param_count
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train import (accumulate_grads, build_train_step,
                                   init_train_state)

    t_phase = time.perf_counter()
    zero_counts()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 products run in f32, not TF32")
    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(**TRAIN_OPT)
    peaks = peak_flops(name)
    log(f"train: {cfg.name} whole ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}); memory before: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    out = {"checks": train_checks(dev, cfg, opt)}
    log(json.dumps({"train_checks": out["checks"]}))
    gc.collect()
    torch.cuda.empty_cache()

    # -- the main cell: timed steps -------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    (state, t_init) = sync_time(lambda: init_train_state(
        cfg, LM_SEED, opt_cfg=opt, device=dev))
    n_params = param_count(state.params)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=LM_SEED)
    step = build_train_step(cfg, opt, remat=TRAIN_REMAT)
    for i in range(TRAIN_WARMUP):
        state, m = step(state, pipe.batch_at(i))
    torch.cuda.synchronize()
    init_GB = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_TIMED):
        (state, m), ms = event_ms(lambda: step(state, pipe.batch_at(i)))
        times.append(ms)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(v) for v in losses), "every timed loss is finite")
    # -- the update alone, on one more step's gradients -----------------------
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(TRAIN_WARMUP + TRAIN_TIMED).items()}
    grads, _ = accumulate_grads(cfg, state.params, batch, remat=TRAIN_REMAT)
    upd = [event_ms(lambda: adamw_update(grads, state.opt, state.params,
                                         opt))[1] for _ in range(4)][1:]
    # -- loss_fn against the cross-entropy of forward's logits ---------------
    with torch.no_grad():
        loss, _ = loss_fn(state.params, cfg, batch)
        logits = forward(state.params, cfg, batch["tokens"]).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        ce = float((lse - gold).mean())
    del logits, lse, gold, grads
    check(abs(float(loss) - ce) <= TRAIN_LOGITS_RTOL * abs(ce),
          f"loss_fn {float(loss)} equals the CE of forward's logits {ce} "
          f"within {TRAIN_LOGITS_RTOL}")
    work = train_work(cfg, TRAIN_BATCH, TRAIN_SEQ, n_params, TRAIN_REMAT)
    upd_bound = 28 * n_params / bw * 1e3
    out["main"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "state_GB": 16 * n_params / 1e9, "init_s": t_init,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": TRAIN_REMAT,
        "step_ms": times, "step_ms_median": statistics.median(times),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
        / statistics.median(times) * 1e3,
        "losses": losses, "max_memory_allocated_GB": peak,
        "max_memory_allocated_GB_warmup": init_GB,
        "update_ms": upd, "update_ms_median": statistics.median(upd),
        "update_bound_ms": upd_bound,
        "loss_fn_vs_forward_ce": {"loss_fn": float(loss), "ce": ce},
        "work": work,
        "bound_ms_by": {w: lm_bound_ms(work[w], bw, peaks) for w in work}}
    log(json.dumps({"train": out["main"]}))
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- the loss decreases on the planted-structure stream ------------------
    state = init_train_state(cfg, LM_SEED, opt_cfg=opt, device=dev)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_DECREASE_SEQ, seed=LM_SEED)
    losses = []
    for i in range(TRAIN_DECREASE_STEPS):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(all(math.isfinite(v) for v in losses)
          and last < first - TRAIN_DECREASE_MARGIN,
          f"the loss decreased by more than {TRAIN_DECREASE_MARGIN}: first "
          f"5 {first}, last 5 {last}")
    out["decrease"] = {"steps": TRAIN_DECREASE_STEPS, "batch": TRAIN_BATCH,
                       "seq": TRAIN_DECREASE_SEQ, "losses": losses,
                       "first5": first, "last5": last}
    log(json.dumps({"train_decrease": out["decrease"]}))
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # -- one step of each other family ------------------------------------------
    for arch, seq in TRAIN_FAMILIES.items():
        out[arch] = train_family(dev, arch, seq, bw, peaks)
        gc.collect()
        torch.cuda.empty_cache()
    counts = read_counts()
    log(f"phase 11 launches: {counts}")
    check(not any(counts.values()), "training launches no match kernel")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11: {out['seconds']:.1f} s")
    return out


def sharded_step_flops(cfg, batch: int, seq: int) -> int:
    """The product FLOPs (those ``FlopCounterMode`` counts: mm, bmm) of the
    port's train step with ``remat="full"`` on ``batch`` x ``seq`` tokens
    of a model of ``attn+mlp`` layers, worked out from the code: per layer
    the projections 2t*d*(H+2KV)*hd + 2t*H*hd*d, attention's full-block
    products 4*batch*seq^2*H*hd (query chunks against every key chunk) and
    the MLP 6t*d*F; the head 2t*d*V.  The forward runs each once and the
    backward twice; remat's recompute of each layer runs the layer again
    but stops before its last product (the MLP's down projection, whose
    output nothing saved needs), and the query-chunk checkpoint nested in
    it recomputes attention once more; each loss chunk's head product runs
    once more in the backward."""
    t = batch * seq
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * t * d * (nh + 2 * kv) * hd + 2 * t * nh * hd * d
    attn = 4 * batch * seq * seq * nh * hd
    mlp = 6 * t * d * f
    layer = 4 * (proj + mlp) - 2 * t * f * d + 5 * attn
    return cfg.n_layers * layer + 4 * 2 * t * d * v


def sharding_phase(dev, name: str, bw: float, unsharded: dict) -> dict:
    """Phase 12: the sharding rules and specs, the data-parallel step on a
    mesh of one card at ``TRAIN_ARCH``'s full width and depth against the
    unsharded step, a checkpoint of the sharded state restored onto the
    mesh, and the dry run of its ``train_4k`` cell.  ``unsharded`` is phase
    11's main record; the match kernels' counters are zeroed before and
    read after (none launched).  Returns the phase's record."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config, train_settings
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import make_production_mesh, mesh_for_devices
    from repro_torch.launch.dryrun import run_cell, shard_bytes
    from repro_torch.models import param_count
    from repro_torch.models.params import param_shapes
    from repro_torch.optim import AdamWConfig
    from repro_torch.pytree import tree_leaves
    from repro_torch.sharding import make_rules
    from repro_torch.train import input_specs

    t_phase = time.perf_counter()
    zero_counts()
    out = {"state_bytes_per_device": {}}
    # -- per-device state of the train_4k cell on the production meshes ----
    shape = SHAPES["train_4k"]
    for arch in SHARD_STATE_ARCHS:
        rec = {}
        for multi_pod in (False, True):
            mesh = make_production_mesh(multi_pod=multi_pod)
            st = train_settings(arch)
            rules = make_rules(mesh, dp_only=st.get("dp_only", False))
            specs = input_specs(get_config(arch), shape, rules, st)
            rec["multipod" if multi_pod else "singlepod"] = sum(
                shard_bytes(t, rules.sizes)
                for t in tree_leaves(specs["state"]))
        out["state_bytes_per_device"][arch] = rec
    log(json.dumps({"sharding_state_bytes": out["state_bytes_per_device"]}))

    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(**TRAIN_OPT)
    peaks = peak_flops(name)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=LM_SEED)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1,
            device_id=torch.device("cuda", 0))
        try:
            mesh = mesh_for_devices(1)
            rules = make_rules(mesh, dp_only=True)
            out.update(sharded_runs(dev, cfg, opt, pipe, rules, bw, peaks,
                                    unsharded, tmp))
        finally:
            dist.destroy_process_group()
            gc.collect()
            torch.cuda.empty_cache()

    # -- the dry run of the cell -----------------------------------------------
    t0 = time.perf_counter()
    rec = run_cell(TRAIN_ARCH, "train_4k", multi_pod=False, save=False)
    rec["run_s"] = time.perf_counter() - t0
    per = shape.global_batch // rec["derived"]["work_shards"]
    want = sharded_step_flops(cfg, per, shape.seq_len)
    work = train_work(cfg, per, shape.seq_len,
                      param_count(param_shapes(cfg)), TRAIN_REMAT)["reference"]
    ref = work["bf16_ops"] + work["f32_ops"]
    ratio = rec["cost"]["flops"] / want
    rec["flops_vs_derived"] = ratio
    rec["flops_vs_train_work"] = rec["cost"]["flops"] / ref
    log(json.dumps({"dryrun": rec}))
    check(abs(ratio - 1) <= SHARD_FLOPS_TOL,
          f"the dry run's FLOPs per device {rec['cost']['flops']:.6g} lie "
          f"within {SHARD_FLOPS_TOL} of the derived {want:.6g}")
    out["dryrun"] = rec
    counts = read_counts()
    log(f"phase 12 launches: {counts}")
    check(not any(counts.values()), "the sharded step launches no match "
          "kernel")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12: {out['seconds']:.1f} s")
    return out


def sharded_runs(dev, cfg, opt, pipe, rules, bw: float, peaks: tuple,
                 unsharded: dict, tmp: str) -> dict:
    """Phase 12 on the mesh of ``rules``: ``SHARD_STEPS`` steps unsharded
    and sharded from one seed, equal bit for bit; the sharded step timed;
    a checkpoint of its state restored with ``restore_resharded`` gives
    the next step bit for bit."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager, restore_resharded
    from repro_torch.models import param_count
    from repro_torch.pytree import tree_leaves
    from repro_torch.train import build_train_step, init_train_state

    def leaves(state):
        return [t.full_tensor() if isinstance(t, DTensor) else t
                for t in tree_leaves(state)]

    out = {}
    plain = build_train_step(cfg, opt, remat=TRAIN_REMAT)
    step = build_train_step(cfg, opt, rules=rules, remat=TRAIN_REMAT)
    # -- unsharded and sharded, bit for bit -----------------------------------
    # the embedding's backward adds with float atomics on the card: both
    # runs use PyTorch's deterministic algorithms
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state = init_train_state(cfg, LM_SEED, opt_cfg=opt, device=dev)
        want_loss = []
        for i in range(SHARD_STEPS):
            state, m = plain(state, pipe.batch_at(i))
            want_loss.append(m["loss"])
        want = [t.cpu() for t in leaves(state)]
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
        state = init_train_state(cfg, LM_SEED, opt_cfg=opt, device=dev,
                                 rules=rules)
        check(all(isinstance(t, DTensor) for t in tree_leaves(
            (state.params, state.opt.mu, state.opt.nu))),
              "the sharded state rests in DTensors")
        got_loss = []
        for i in range(SHARD_STEPS):
            state, m = step(state, pipe.batch_at(i))
            got_loss.append(m["loss"])
        got = leaves(state)
        check(len(got) == len(want) and all(
            torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"every param, mu and nu leaf after {SHARD_STEPS} steps on the "
              "mesh of one equals the unsharded step's bit for bit")
        check(all(torch.equal(a, b) for a, b in zip(got_loss, want_loss)),
              "the losses equal the unsharded step's bit for bit")
        out["equal"] = {"steps": SHARD_STEPS, "leaves": len(got),
                        "losses": [float(v) for v in got_loss]}
        del got, want
    finally:
        torch.use_deterministic_algorithms(False)
    log(json.dumps({"sharded_equal": out["equal"]}))
    # -- the sharded step timed -------------------------------------------------
    n_params = param_count(state.params)
    for i in range(SHARD_STEPS, SHARD_STEPS + TRAIN_WARMUP):
        state, m = step(state, pipe.batch_at(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    first = SHARD_STEPS + TRAIN_WARMUP
    for i in range(first, first + TRAIN_TIMED):
        (state, m), ms = event_ms(lambda: step(state, pipe.batch_at(i)))
        times.append(ms)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(v) for v in losses), "every timed loss is finite")
    work = train_work(cfg, TRAIN_BATCH, TRAIN_SEQ, n_params, TRAIN_REMAT)
    med = statistics.median(times)
    out["main"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "mesh": dict(rules.sizes), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "remat": TRAIN_REMAT, "step_ms": times, "step_ms_median": med,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
        "losses": losses, "max_memory_allocated_GB": peak,
        "unsharded_step_ms_median": unsharded["step_ms_median"],
        "unsharded_tokens_per_s": unsharded["tokens_per_s"],
        "unsharded_max_memory_allocated_GB":
            unsharded["max_memory_allocated_GB"],
        "work": work,
        "bound_ms_by": {w: lm_bound_ms(work[w], bw, peaks) for w in work}}
    log(json.dumps({"sharded_train": out["main"]}))
    # -- checkpoint of the sharded state, restored onto the mesh ----------------
    k = first + TRAIN_TIMED
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), keep=1)
    t0 = time.perf_counter()
    mgr.save(k, state)
    save_s = time.perf_counter() - t0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        nxt, wm = step(state, pipe.batch_at(k))
        want = [t.cpu() for t in leaves(nxt)]
        del state, nxt
        gc.collect()
        torch.cuda.empty_cache()
        fresh = init_train_state(cfg, LM_SEED + 1, opt_cfg=opt, device=dev,
                                 rules=rules)
        t0 = time.perf_counter()
        restored, at = restore_resharded(mgr, fresh)
        restore_s = time.perf_counter() - t0
        del fresh
        check(at == k and int(restored.opt.step) == k and all(
            isinstance(t, DTensor) for t in tree_leaves(restored.params)),
              f"restored step {k} onto the mesh")
        nxt, gm = step(restored, pipe.batch_at(k))
        check(all(torch.equal(a.cpu(), b) for a, b in zip(leaves(nxt), want))
              and all(torch.equal(gm[n], wm[n]) for n in wm),
              "the step after the restore equals the step from the saved "
              "state bit for bit")
    finally:
        torch.use_deterministic_algorithms(False)
    out["checkpoint"] = {"step": k, "save_s": save_s,
                         "restore_s": restore_s,
                         "GB": sum(t.numel() * t.element_size()
                                   for t in want) / 1e9}
    log(json.dumps({"sharded_checkpoint": out["checkpoint"]}))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.core import (DT2CAM, NonIdealSpec, apply_saf,
                                  compile_tree, encode_inputs, predict,
                                  train_tree)
    from repro_torch.core.lut import CELL_MM, bitplanes
    from repro_torch.dt import DATASETS, load_split
    from repro_torch.kernels import (build_all, prepare_match, sa_kmax,
                                     select_engine, tcam_infer,
                                     tcam_match_bits_cuda, tcam_match_cuda,
                                     tcam_match_packed_bits_cuda,
                                     tcam_match_packed_cuda, tcam_match_plain)
    from repro_torch.kernels._cuda import launch_match_bits
    from repro_torch.serve import ServeConfig, TCAMServer

    dev = torch.device("cuda")
    # -- 1. the card -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    # -- 2. set-up: build the kernels ----------------------------------------
    t0 = time.perf_counter()
    reports = build_all()
    log(f"setup: kernel build {time.perf_counter() - t0:.2f} s")
    record_ptxas(reports)

    # -- 3. main path at credit scale ------------------------------------------
    spec = DATASETS["credit"]
    Xtr, ytr, Xte, _ = load_split("credit")
    check(Xtr.shape == (108242, 10) and Xte.shape == (12027, 10),
          f"credit split {Xtr.shape} / {Xte.shape}")
    t0 = time.perf_counter()
    tree = train_tree(Xtr, ytr, max_depth=spec.max_depth,
                      max_leaves=spec.max_leaves,
                      min_samples_leaf=spec.min_samples_leaf)
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = compile_tree(tree, s=128)
    t_compile = time.perf_counter() - t0
    lay = compiled.layout
    log(f"credit: fit {t_fit:.2f} s, compile {t_compile:.2f} s, layout "
        f"{lay.cells.shape}, n_rwd={lay.n_rwd}, n_cwd={lay.n_cwd}, LUT "
        f"{compiled.lut_shape}")
    check(lay.cells.shape == (8576, 4992) and lay.n_rwd == 67
          and lay.n_cwd == 39 and compiled.lut_shape == (8476, 4937),
          "credit layout dims")
    golden = predict(tree, Xte)
    xbits = encode_inputs(compiled.lut, Xte)

    zero_counts()
    check(select_engine(lay.cells, lay.s, "auto") == "packed",
          "auto resolves to packed on ideal hardware")
    ideal = {}
    for engine in ("auto", "mxu", "ref"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ideal[engine] = r = tcam_infer(lay, xbits, engine=engine, device=dev)
        dt = time.perf_counter() - t0
        check(np.array_equal(r.predictions, golden),
              f"{engine}: predictions equal the tree's own")
        check(bool((r.n_survivors == 1).all()), f"{engine}: one survivor each")
        log(f"credit tcam_infer engine={engine}: {dt * 1e3:.1f} ms for "
            f"{len(Xte)} queries, mean active evals "
            f"{r.active_evals.mean():.3f}, {r.mean_energy * 1e9:.6f} nJ/dec")
    same_result(ideal["auto"], ideal["mxu"], "ideal auto vs mxu")
    same_result(ideal["auto"], ideal["ref"], "ideal auto vs ref")

    model = DT2CAM(s=128)
    model.compiled = compiled
    saf = NonIdealSpec(p_sa0=0.01, p_sa1=0.01, sa_sigma=0.05)
    faulted = apply_saf(lay.cells, saf.p_sa0, saf.p_sa1,
                        np.random.default_rng(0))
    check(bool((faulted == CELL_MM).any())
          and select_engine(faulted, lay.s, "auto") == "mxu",
          "auto resolves to mxu under stuck faults")
    noisy = {e: model.infer(Xte, backend="torch", engine=e, nonideal=saf,
                            rng=np.random.default_rng(0))
             for e in ("auto", "ref")}
    same_result(noisy["auto"], noisy["ref"], "non-ideal auto vs ref")
    log(f"credit non-ideal (p_sa0=p_sa1=0.01, sa_sigma=0.05): accuracy vs "
        f"tree {float((noisy['auto'].predictions == golden).mean()):.4f}")

    cXtr, cytr, cXte, _ = load_split("covid")
    cm = DT2CAM(s=128).fit(cXtr, cytr)
    got = cm.infer(cXte, backend="torch")
    same_result(got, cm.infer(cXte, backend="sim"), "covid torch vs sim")
    check(np.array_equal(got.predictions, cm.golden_predict(cXte)),
          "covid predictions equal the tree's own")
    counts = read_counts()
    launches = {"tcam_match": counts["tcam_match_bits_cuda"],
                "tcam_packed": counts["tcam_match_packed_bits_cuda"]}
    log(f"main path launches: {counts}")
    check(all(n > 0 for n in launches.values()),
          "both kernels launched on the main path")
    check(counts["tcam_match_cuda"] == counts["tcam_match_banked_cuda"]
          == counts["tcam_match_banked_bits_cuda"] == 0,
          "the main path runs the bitplane kernel through its prepacked entry")
    check(counts["tcam_match_packed_cuda"] == 0,
          "auto runs the packed kernel through its prepacked entry only")
    check(counts["path_tiled"] == launches["tcam_match"]
          and counts["path_any"] == 0,
          "every bitplane launch took the tiled path")
    check(counts["packed_path_tiled"] == launches["tcam_packed"]
          and counts["packed_path_any"] == 0,
          "every packed launch took the tiled path")
    check(counts["pack_words_cuda"] == sum(launches.values()),
          "one word pack per match launch")
    check(counts["pack_planes_cuda"] > 0, "operands packed at prepare")

    # -- 4. kernels at the credit shapes --------------------------------------
    x = torch.from_numpy(lay.pad_inputs(xbits)).to(dev)
    offsets = np.random.default_rng(1).normal(0.0, 0.08, (lay.cells.shape[0],
                                                          lay.n_cwd))
    km_np = sa_kmax(lay, offsets)
    check(bool((km_np == -1).any() and (km_np == 0).any()
               and (km_np > 0).any()), "kmax holds -1, 0 and >0")
    km = torch.from_numpy(km_np).to(dev)
    bw = peak_bw(name)
    shape = {"B": x.shape[0], "R": km.shape[0], "W": x.shape[1], "S": lay.s,
             "D": km.shape[1]}

    rates = pipe_rates()
    packed = packed_row(lay, x, km_np, km, shape, launches["tcam_packed"], bw,
                        rates)

    f0, f1 = (torch.from_numpy(p).to(dev) for p in bitplanes(faulted))
    ops = prepare_match(faulted, lay.s, km_np, engine="mxu", device=dev)
    xb16, f0b16 = x.to(torch.bfloat16), f0.to(torch.bfloat16)
    bitplane = measure("tcam_match", [{
        "run": lambda: tcam_match_bits_cuda(x, ops.a, ops.kmax, s=lay.s),
        "plain": lambda: tcam_match_plain(x, f0, f1, lay.s, km),
        "library": lambda: torch.matmul(xb16, f0b16.T),
        "extra": lambda got: match_extra(
            [t[None] for t in got], x[None], f0[None], f1[None], ops.a[None],
            ops.kmax[None], lay.s,
            lambda: [t[None] for t in tcam_match_cuda(x, f0, f1, km,
                                                      s=lay.s)],
            launch_match_bits, "match_bits_kernel"),
        "inputs": (x, ops.a, ops.kmax),
        "ops": lambda got: bitplane_ops(got[1], lay.s), "shape": shape,
    }], launches["tcam_match"], bw, rates)
    bitplane["library_call"] = "bf16 torch.matmul (B,W)x(W,R): products only"
    del xb16, f0b16, f0, f1, ops

    # -- 5. serving -------------------------------------------------------------
    zero_counts()
    n = SERVE_REQUESTS
    with TCAMServer(compiled, config=ServeConfig(max_batch=256),
                    device="cuda") as srv:
        t0 = time.perf_counter()
        builds = srv.warmup()
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        futs = srv.submit_many(Xte[:n])
        res = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        stats = srv.metrics()
    want = ideal["auto"]
    for f, arr in (("prediction", want.predictions),
                   ("survivor", want.survivors),
                   ("n_survivors", want.n_survivors),
                   ("active_evals", want.active_evals),
                   ("energy_j", want.energy_per_dec)):
        check(np.array_equal([getattr(r, f) for r in res], arr[:n]),
              f"served {f} equals tcam_infer's")
    check(tcam_match_packed_bits_cuda.launches > 0
          and tcam_match_packed_cuda.launches == 0,
          "serving ran the packed kernel through its prepacked entry")
    cl = stats["compute_latency"]
    log(json.dumps({
        "serve": {"engine": stats["engine"], "requests": n,
                  "warmup_builds": builds, "warmup_s": t_warm,
                  "wall_s": wall, "requests_per_s": n / wall,
                  "batches": stats["batches"],
                  "mean_batch_fill": stats["mean_batch_fill"],
                  "compute_p50_ms": cl["p50_ms"],
                  "compute_p99_ms": cl["p99_ms"],
                  "total_p50_ms": stats["total_latency"]["p50_ms"],
                  "total_p99_ms": stats["total_latency"]["p99_ms"],
                  "packed_launches": tcam_match_packed_bits_cuda.launches}}))

    del x, km

    # -- 6. forest ----------------------------------------------------------------
    banked, forest = forest_phase(dev, bw, rates)

    # -- 7. chip health and lifecycle ---------------------------------------------
    health_phase(dev, tree, Xtr, ytr, Xte, golden, ideal["auto"], forest)

    # -- 8. drift, margins and scrub ------------------------------------------------
    drift_phase(dev, compiled, Xte, golden, ideal["auto"])

    # -- 9. the LM serving path at full width ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    lm_phase(dev, name, bw)

    # -- 10. the recurrent and encoder-decoder families at full width -------
    gc.collect()
    torch.cuda.empty_cache()
    lm_families_phase(dev, name, bw)

    # -- 11. training at olmo-1b's full width and depth -------------------------
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_phase(dev, name, bw)

    # -- 12. sharding: the data-parallel step on a mesh of one, the dry run --
    gc.collect()
    torch.cuda.empty_cache()
    sharding_phase(dev, name, bw, trained["main"])

    # -- 13. result --------------------------------------------------------------
    log(smi)
    log(json.dumps({"kernels": [bitplane, packed, banked]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
