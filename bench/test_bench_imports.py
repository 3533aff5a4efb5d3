"""Nothing the benchmark runs loads JAX, the JAX package (``repro``) or
``benchmarks/``: every import in ``bench/`` by its top-level name,
compared whole (``repro_torch`` begins with ``repro`` and passes), and
``sys.modules`` after a whole run in a fresh process.  The reference
imports nothing of the port."""
from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
BARRED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add((node.module or "").split(".")[0])
    return out


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_barred_import(path):
    assert not _imports(path) & BARRED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)
    assert not [n for n in ast.walk(ast.parse(path.read_text()))
                if isinstance(n, ast.ImportFrom) and n.level > 0
                and n.module not in (None, "adamw", "transformer")]


def test_a_whole_run_loads_nothing_barred():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(BENCH.parent)!r}, "
        f"{str(BENCH.parent / 'src')!r}]\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from bench.small import small_ctx\n"
        "from bench.harness import run_cell, barred_modules\n"
        "out = run_cell(small_ctx('qwen3moe-l4.prefill-mix', 1, 0.1))\n"
        "print(json.dumps({'correct': out['correct'],\n"
        "                  'barred': barred_modules()}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "barred": []}


def test_run_without_the_program_exits_without_a_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and bench/ has no
    program: the run exits non-zero and prints no result line."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "qwen3moe-l4.prefill-mix", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0
    assert '"correct"' not in res.stdout
