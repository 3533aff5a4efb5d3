"""Each CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

The shapes are the kernel sweep of ``test_kernels.py`` plus a larger ragged
one; kmax covers 0, >0 (several survivors), mixed -1/0/>0 and a fully masked
last division (kmax = S).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.core import CELL_MM, TernaryLUT, bitplanes, synthesize

SWEEP = [
    # rows, width, s, batch (as tests/test_kernels.py)
    (9, 12, 16, 7),
    (40, 70, 32, 33),
    (120, 123, 64, 130),
    (50, 200, 128, 16),
    (300, 40, 32, 64),
]


def _random_layout(rng, rows, width, s, with_mm=False):
    cells = rng.integers(0, 3, size=(rows, width)).astype(np.int8)
    if with_mm:
        cells[rng.random((rows, width)) < 0.02] = CELL_MM
    lut = TernaryLUT(cells=cells,
                     classes=rng.integers(0, 4, rows).astype(np.int32),
                     n_classes=4, feat_offsets=np.array([0, width]),
                     thresholds=[np.linspace(0, 1, width - 1)])
    return synthesize(lut, s, seed=int(rng.integers(1 << 30)))


def _kmax(rng, lay, kind):
    r, d = lay.cells.shape[0], lay.n_cwd
    if kind == "zero":
        return np.zeros((r, d), np.int32)
    if kind == "pos":
        return rng.integers(1, lay.s // 2 + 1, size=(r, d)).astype(np.int32)
    if kind == "mixed":
        return rng.integers(-1, 3, size=(r, d)).astype(np.int32)
    km = rng.integers(0, 2, size=(r, d)).astype(np.int32)
    km[:, -1] = lay.s
    return km


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_operands(rows, width, s, b, kind, with_mm, dev):
    rng = np.random.default_rng(rows * 7 + s)
    lay = _random_layout(rng, rows, width, s, with_mm=with_mm)
    xp = lay.pad_inputs(rng.integers(0, 2, size=(b, width)).astype(np.uint8))
    km = torch.from_numpy(_kmax(rng, lay, kind)).to(dev)
    is0, is1 = (torch.from_numpy(p).to(dev) for p in bitplanes(lay.cells))
    return torch.from_numpy(xp).to(dev), is0, is1, km


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["zero", "pos", "mixed", "masked"])
@pytest.mark.parametrize("rows,width,s,b", SWEEP + [(1000, 500, 128, 300)])
def test_bitplane_kernel_equals_plain_on_card(cuda, rows, width, s, b, kind):
    x, is0, is1, km = _kernel_operands(rows, width, s, b, kind, True, cuda)
    before = tk.tcam_match_cuda.launches
    got = tk.tcam_match_cuda(x, is0, is1, km, s=s)
    torch.cuda.synchronize()
    assert tk.tcam_match_cuda.launches == before + 1
    want = tk.tcam_match_plain(x, is0, is1, s, km)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["zero", "pos", "mixed", "masked"])
@pytest.mark.parametrize("rows,width,s,b",
                         [c for c in SWEEP if c[2] % 32 == 0]
                         + [(1000, 500, 128, 300), (70, 300, 96, 40)])
def test_packed_kernel_equals_plain_on_card(cuda, rows, width, s, b, kind):
    x, is0, is1, km = _kernel_operands(rows, width, s, b, kind, False, cuda)
    xq, val, care = (tk.pack_bits(t) for t in (x, is1, is0 | is1))
    before = tk.tcam_match_packed_cuda.launches
    got = tk.tcam_match_packed_cuda(xq, val, care, km, s=s)
    torch.cuda.synchronize()
    assert tk.tcam_match_packed_cuda.launches == before + 1
    want = tk.tcam_match_packed_plain(xq, val, care, s, km)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_bitplane_kernel_unaligned_rows_take_the_byte_path(cuda):
    x, is0, is1, km = _kernel_operands(40, 70, 24, 33, "mixed", True, cuda)
    got = tk.tcam_match_cuda(x, is0, is1, km, s=24)
    want = tk.tcam_match_plain(x, is0, is1, 24, km)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
