"""On the card: one short run of each cell through ``bench/run.py``, its
result line read as the contract has it (a cell of several cards where
the machine has as many).  Marked ``gpu``; skips with a reason where the
cards are missing:

    python -m pytest -q -m gpu bench/
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


def _cards(n: int) -> None:
    import torch
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_runs_on_the_card(card, workload):
    chips = next(w["chips"] for w in MANIFEST["workloads"]
                 if w["name"] == workload)
    _cards(chips)
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"] == {**out["device"], "platform": "gpu",
                             "kind": card, "count": chips}
    assert list(out)[-1] == "checks"
