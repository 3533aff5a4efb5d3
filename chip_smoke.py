#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build the CUDA kernels,
drive the single-tree and forest paths at Give Me Some Credit scale, hold
each kernel against its plain PyTorch version, serve requests, and print
what was measured.

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
   forest serving of 4096 queries with engines mxu and auto (= banked),
   equal to the executor;
7. the kernels line, the card's name and power limit, and the last line:
   ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
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


def forest_phase(dev, bw: float, rates: dict) -> dict:
    """Phase 6: the forest path.  Returns the banked kernel's record."""
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
    serve = {}
    for engine in ("mxu", "auto"):
        zero_counts()
        with TCAMServer(forest, config=ServeConfig(engine=engine,
                                                   max_batch=256),
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
                  f"forest served ({engine}) {f} equals the executor's")
        kernel_launches = tcam_match_banked_bits_cuda.launches
        check((kernel_launches > 0) == (engine == "mxu"),
              f"forest serving on {engine} launched the banked kernel "
              f"{kernel_launches} times")
        cl = stats["compute_latency"]
        serve[engine] = {
            "resolved_engine": stats["engine"], "requests": n,
            "warmup_builds": builds, "warmup_s": t_warm, "wall_s": wall,
            "requests_per_s": n / wall, "batches": stats["batches"],
            "mean_batch_fill": stats["mean_batch_fill"],
            "compute_p50_ms": cl["p50_ms"], "compute_p99_ms": cl["p99_ms"],
            "total_p50_ms": stats["total_latency"]["p50_ms"],
            "total_p99_ms": stats["total_latency"]["p99_ms"],
            "banked_launches": kernel_launches}
    log(json.dumps({"forest_serve": serve}))
    return rec


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
    banked = forest_phase(dev, bw, rates)

    # -- 7. result ---------------------------------------------------------------
    log(smi)
    log(json.dumps({"kernels": [bitplane, packed, banked]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
