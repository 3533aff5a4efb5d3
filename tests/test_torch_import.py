"""The port stands alone: importing it loads neither JAX nor the JAX package,
no source of it (or ``chip_smoke.py``) imports them, and its entry points
refuse to run on a machine without CUDA unless asked for the CPU."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(len(bad), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120, check=True,
    ).stdout
    assert out.startswith("0 "), out


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]
))
def test_sources_do_not_import_jax_or_the_jax_package(path):
    hits = FORBIDDEN.findall((ROOT / path).read_text())
    assert not hits, f"{path} imports {hits}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_default_to_the_cpu(no_cuda):
    from repro_torch import DT2CAM, TCAMServer, resolve_device, tcam_infer
    from repro_torch.dt import load_split
    from repro_torch.kernels import prepare_match, tcam_match

    Xtr, ytr, Xte, _ = load_split("iris")
    m = DT2CAM(s=16, max_depth=3).fit(Xtr, ytr)
    lay = m.compiled.layout
    xpad = np.zeros((2, lay.n_cwd * lay.s), np.uint8)
    calls = [
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: m.infer(Xte, backend="torch"),
        lambda: m.infer(Xte),
        lambda: tcam_infer(lay, np.zeros((2, lay.width), np.uint8)),
        lambda: tcam_match(lay.cells, xpad, lay.s),
        lambda: prepare_match(lay.cells, lay.s),
        lambda: TCAMServer(m.compiled),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asking for the CPU is the one way to run without a card
    assert m.infer(Xte, backend="torch", device="cpu").predictions.shape == (
        len(Xte),)
