#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card(s) of this machine
and print its result as the last line of standard output:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled stretch of the window.  Exits 2 without
a result where CUDA or the cards the cell needs are missing.  Every cache
a build could write goes under ``.bench_cache/`` in the checkout.
"""
import time

T0 = time.perf_counter()     # set-up counts from here, before torch loads

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _environment() -> None:
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    from bench import harness
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
