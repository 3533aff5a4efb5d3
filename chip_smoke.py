#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build the CUDA kernels,
drive the main path at Give Me Some Credit scale, hold each kernel against
its plain PyTorch version, serve requests, and print what was measured.

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
   and read after it;
4. kernels at the credit shapes (B=12027, R=8576, W=4992, S=128, D=39), with
   an SA-variability kmax holding -1, 0 and >0: kernel == plain version
   (``torch.equal``), then CUDA-event medians of the kernel, the plain
   version and a PyTorch yardstick, beside the least time the card could
   take (bytes over the card's memory rate, operations over its peak);
5. serving: ``TCAMServer`` on credit, warmed up, serving 4096 test queries;
   results equal ``tcam_infer``'s;
6. the last line: ``{"ok": true, "device": {...}}``.

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
PEAK_INT8_TENSOR = 1979e12   # dense int8 tensor-core rate, H100 SXM
PEAK_CUDA_CORE = 67e12       # non-tensor fp32 rate, H100 SXM (int32 ALU bound)
SERVE_REQUESTS = 4096


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


def same_result(a, b, what: str) -> None:
    import dataclasses

    import numpy as np
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        ok = np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        check(bool(ok), f"{what}: SimResult.{f.name} differs")


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
    from repro_torch.kernels import (build_all, pack_bits, sa_kmax,
                                     select_engine, tcam_infer,
                                     tcam_match_cuda, tcam_match_packed_cuda,
                                     tcam_match_packed_plain, tcam_match_plain)
    from repro_torch.serve import ServeConfig, TCAMServer

    dev = torch.device("cuda")
    # -- 1. the card -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    # -- 2. set-up: build the kernels ----------------------------------------
    t0 = time.perf_counter()
    reports = build_all()
    log(f"setup: kernel build {time.perf_counter() - t0:.2f} s")
    for src, out in reports.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

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

    tcam_match_cuda.launches = 0
    tcam_match_packed_cuda.launches = 0
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
    launches = {"tcam_match": tcam_match_cuda.launches,
                "tcam_packed": tcam_match_packed_cuda.launches}
    log(f"main path launches: {launches}")
    check(all(n > 0 for n in launches.values()),
          "both kernels launched on the main path")

    # -- 4. kernels at the credit shapes --------------------------------------
    x = torch.from_numpy(lay.pad_inputs(xbits)).to(dev)
    offsets = np.random.default_rng(1).normal(0.0, 0.08, (lay.cells.shape[0],
                                                          lay.n_cwd))
    km_np = sa_kmax(lay, offsets)
    check(bool((km_np == -1).any() and (km_np == 0).any()
               and (km_np > 0).any()), "kmax holds -1, 0 and >0")
    km = torch.from_numpy(km_np).to(dev)
    bw = peak_bw(name)
    b_, w_ = x.shape
    r_, d_ = km.shape
    out_bytes = 2 * b_ * r_ * 4

    def measure(kname, run, plain, inputs, ops_per_eval, op_peak, library):
        got = run()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"{kname}: kernel == plain version")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        evals_total = int(got[1].sum(dtype=torch.int64))
        in_bytes = sum(t.numel() * t.element_size() for t in inputs)
        t_bytes = (in_bytes + out_bytes) / bw * 1e3
        t_ops = evals_total * ops_per_eval / op_peak * 1e3
        rec = {
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": {"tcam_match": "src/repro/kernels/tcam_match.py:38",
                         "tcam_packed": "src/repro/kernels/tcam_packed.py:30"
                         }[kname],
            "launches": launches[kname],
            "max_abs_err": err,
            "ms": cuda_ms(run, reps=10, warmup=2),
            "plain_ms": cuda_ms(plain, reps=3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if library is None else cuda_ms(library, 10, 2),
            "bytes": in_bytes + out_bytes,
            "evaluated_divisions": evals_total,
            "shape": {"B": b_, "R": r_, "W": w_, "S": lay.s, "D": d_},
        }
        log(json.dumps(rec))
        return rec

    is0, is1 = bitplanes(lay.cells)
    xq = pack_bits(x)
    val = pack_bits(torch.from_numpy(is1).to(dev))
    care = pack_bits(torch.from_numpy(is0 | is1).to(dev))
    sw = lay.s // 32
    packed = measure(
        "tcam_packed",
        lambda: tcam_match_packed_cuda(xq, val, care, km, s=lay.s),
        lambda: tcam_match_packed_plain(xq, val, care, lay.s, km),
        (xq, val, care, km), 3 * sw, PEAK_CUDA_CORE, None)
    del val, care

    f0, f1 = (torch.from_numpy(p).to(dev) for p in bitplanes(faulted))
    xb16, f0b16 = x.to(torch.bfloat16), f0.to(torch.bfloat16)
    bitplane = measure(
        "tcam_match",
        lambda: tcam_match_cuda(x, f0, f1, km, s=lay.s),
        lambda: tcam_match_plain(x, f0, f1, lay.s, km),
        (x, f0, f1, km), 4 * lay.s, PEAK_INT8_TENSOR,
        lambda: torch.matmul(xb16, f0b16.T))
    bitplane["library_call"] = "bf16 torch.matmul (B,W)x(W,R): products only"
    del xb16, f0b16, f0, f1

    # -- 5. serving -------------------------------------------------------------
    tcam_match_cuda.launches = 0
    tcam_match_packed_cuda.launches = 0
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
    check(tcam_match_packed_cuda.launches > 0, "serving ran the packed kernel")
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
                  "packed_launches": tcam_match_packed_cuda.launches}}))

    # -- 6. result ---------------------------------------------------------------
    log(smi)
    log(json.dumps({"kernels": [bitplane, packed]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
