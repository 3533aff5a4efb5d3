"""Each CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

The shapes are the kernel sweep of ``test_kernels.py`` plus a larger ragged
one; kmax covers 0, >0 (several survivors), mixed -1/0/>0 and a fully masked
last division (kmax = S).  The banked entry of the bitplane kernel (a bank
grid axis) runs the same sweep over G = 1 and 3 stacked banks of unequal
size, with pad rows (kmax -1) and an all-don't-care pad division, and once
at more than 2^31 output elements.

The bitplane kernel runs on bit-packed, division-major operands: the pack
kernel against ``pack_bits`` and the plain packing, the prepacked entries
(the main path's) against the uint8 ones, tile-edge shapes (B and R one
either side of the 128 x 128 tile), a case of divergent warps, and the
launch counts by path.

The packed kernel runs on division-major operands too (``vc`` = val and
care words per (division, row)): its prepacked entry (the main path's)
against both plain versions over the sweep, tile edges
(B = 63/64/65, R = 127/128/129 around its 128-row x 64-word tile), one
warp whose rows take every test (kmax -1, 0, > 0 and all-don't-care
divisions), search words repeated within a tile (the kernel tests one
word per class of equal words), the wide path (S = 160, 256) with launch
counts by path, and its row-major entry against the prepacked one.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.core import CELL_MM, CELL_X, TernaryLUT, bitplanes, synthesize

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
    """S = 24: uint8 rows that are not 16-byte aligned, which the packing
    takes through its ballot kernel and pads to one word a division."""
    x, is0, is1, km = _kernel_operands(40, 70, 24, 33, "mixed", True, cuda)
    got = tk.tcam_match_cuda(x, is0, is1, km, s=24)
    want = tk.tcam_match_plain(x, is0, is1, 24, km)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def banked_group(rows, width, s, b, g, kind="mixed", pad_div=1):
    """G banks of unequal size with CELL_MM cells, stacked as
    ``forest.plan`` stacks them: pad rows carry kmax -1 and ``pad_div`` pad
    divisions are all don't-care; each bank has its own search words.
    Returns numpy (cells (G, R, W), xpad (G, B, W), kmax (G, R, D))."""
    rng = np.random.default_rng(rows * 7 + s + 31 * g)
    lays = [_random_layout(rng, max(2, rows - 3 * i), max(2, width - 2 * i),
                           s, with_mm=True) for i in range(g)]
    r_pad = max(l.cells.shape[0] for l in lays) + 5
    d_pad = max(l.n_cwd for l in lays) + pad_div
    cells = np.full((g, r_pad, d_pad * s), CELL_X, np.int8)
    kmax = np.full((g, r_pad, d_pad), -1, np.int32)
    xpad = np.zeros((g, b, d_pad * s), np.uint8)
    for i, lay in enumerate(lays):
        r, w = lay.cells.shape
        cells[i, :r, :w] = lay.cells
        kmax[i, :r, :] = 0
        kmax[i, :r, : lay.n_cwd] = _kmax(rng, lay, kind)
        xpad[i, :, :w] = lay.pad_inputs(
            rng.integers(0, 2, size=(b, lay.width)).astype(np.uint8))
    return cells, xpad, kmax


def _banked_operands(rows, width, s, b, g, kind, dev):
    cells, xpad, kmax = banked_group(rows, width, s, b, g, kind)
    is0, is1 = bitplanes(cells)
    return tuple(torch.from_numpy(a).to(dev) for a in (xpad, is0, is1, kmax))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["zero", "pos", "mixed", "masked"])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("rows,width,s,b", SWEEP + [(1000, 500, 128, 300)])
def test_banked_kernel_equals_plain_on_card(cuda, rows, width, s, b, g, kind):
    x, is0, is1, km = _banked_operands(rows, width, s, b, g, kind, cuda)
    before = tk.tcam_match_banked_cuda.launches
    got = tk.tcam_match_banked_cuda(x, is0, is1, km, s=s)
    torch.cuda.synchronize()
    assert tk.tcam_match_banked_cuda.launches == before + 1
    want = tk.tcam_match_banked_plain(x, is0, is1, s, km)
    for gt, w in zip(got, want):
        assert gt.shape == (g, b, is0.shape[1])
        assert torch.equal(gt, w)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,width,s,b", SWEEP)
def test_banked_kernel_at_one_bank_equals_the_single_bank_kernel(
        cuda, rows, width, s, b):
    x, is0, is1, km = _kernel_operands(rows, width, s, b, "mixed", True, cuda)
    got = tk.tcam_match_banked_cuda(x[None], is0[None], is1[None], km[None],
                                    s=s)
    want = tk.tcam_match_cuda(x, is0, is1, km, s=s)
    torch.cuda.synchronize()
    for gt, w in zip(got, want):
        assert torch.equal(gt[0], w)


@pytest.mark.gpu
def test_banked_kernel_unaligned_rows_take_the_byte_path(cuda):
    """As the single-bank case, over three banks."""
    x, is0, is1, km = _banked_operands(40, 70, 24, 33, 3, "mixed", cuda)
    got = tk.tcam_match_banked_cuda(x, is0, is1, km, s=24)
    want = tk.tcam_match_banked_plain(x, is0, is1, 24, km)
    for gt, w in zip(got, want):
        assert torch.equal(gt, w)


@pytest.mark.gpu
def test_banked_kernel_past_two_to_the_31_output_elements(cuda):
    """(G, B, R) = (4, 16384, 36864): 2.42e9 elements per output, so the
    last bank's slab lies partly beyond 2^31.  kmax in {-1, 43, S} makes
    survive and evals depend on both the word and the row; the last bank
    is held against the plain version."""
    g, b, r, s = 4, 16384, 36864, 128
    need = 2 * g * b * r * 4 + 12 * b * r * 4      # outputs + plain's temps
    if torch.cuda.mem_get_info(cuda)[0] < need:
        pytest.skip(f"needs {need / 2**30:.0f} GiB free on the card")
    gen = torch.Generator(device=cuda).manual_seed(0)
    cells = torch.randint(0, 3, (g, r, 2 * s), device=cuda, generator=gen)
    is0 = (cells == 0).to(torch.uint8)
    is1 = (cells == 1).to(torch.uint8)
    x = torch.randint(0, 2, (g, b, 2 * s), device=cuda, generator=gen,
                      dtype=torch.uint8)
    choice = torch.tensor([-1, 43, s], dtype=torch.int32, device=cuda)
    km = choice[torch.randint(0, 3, (g, r, 2), device=cuda, generator=gen)]
    del cells
    survive, evals = tk.tcam_match_banked_cuda(x, is0, is1, km, s=s)
    torch.cuda.synchronize()
    assert survive.numel() > 2**31
    want = tk.tcam_match_banked_plain(x[-1:], is0[-1:], is1[-1:], s, km[-1:])
    assert torch.equal(survive[-1:], want[0])
    assert torch.equal(evals[-1:], want[1])
    assert 0 < int(want[0].sum()) < b * r and int((want[1] == 2).sum()) > 0


# -- the bit-packed operands -----------------------------------------------
TILE = 128   # rows and search words of one block of the bitplane kernel


@pytest.mark.gpu
@pytest.mark.parametrize("s", [16, 24, 32, 64, 96, 128, 160])
@pytest.mark.parametrize("g,b,w_divs", [(1, 1, 1), (3, 37, 5), (2, 130, 39)])
def test_pack_kernel_equals_pack_bits(cuda, s, g, b, w_divs):
    gen = torch.Generator(device=cuda).manual_seed(s + b)
    x = torch.randint(0, 2, (g, b, w_divs * s), device=cuda, generator=gen,
                      dtype=torch.uint8)
    before = tk.pack_words_cuda.launches
    xw = tk.pack_words_cuda(x, s=s)
    torch.cuda.synchronize()
    assert tk.pack_words_cuda.launches == before + 1
    assert torch.equal(xw, tk.pack_words(x, s))
    if s % 32 == 0:
        want = tk.pack_bits(x).view(g, b, w_divs, s // 32).transpose(1, 2)
        assert torch.equal(xw[:, :, :b], want)
    p1 = torch.randint(0, 2, x.shape, device=cuda, generator=gen,
                       dtype=torch.uint8)
    assert torch.equal(tk.pack_planes_cuda(x, p1, s=s),
                       tk.pack_planes(x, p1, s))


def _prepacked(x, is0, is1, km, s):
    return (tk.pack_planes_cuda(is0[None], is1[None], s=s)[0],
            km.t().contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["zero", "pos", "mixed", "masked"])
@pytest.mark.parametrize("rows,width,s,b", SWEEP + [(1000, 500, 128, 300)])
def test_prepacked_entry_equals_uint8_entry(cuda, rows, width, s, b, kind):
    x, is0, is1, km = _kernel_operands(rows, width, s, b, kind, True, cuda)
    planes, kt = _prepacked(x, is0, is1, km, s)
    before = tk.tcam_match_bits_cuda.launches
    got = tk.tcam_match_bits_cuda(x, planes, kt, s=s)
    torch.cuda.synchronize()
    assert tk.tcam_match_bits_cuda.launches == before + 1
    want = tk.tcam_match_cuda(x, is0, is1, km, s=s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, tk.tcam_match_plain(x, is0, is1, s, km)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [32, 128])
@pytest.mark.parametrize("b", [TILE - 1, TILE, TILE + 1])
@pytest.mark.parametrize("rows", [TILE - 1, TILE + 1])
def test_bitplane_kernel_at_tile_edges(cuda, rows, b, s):
    """Random cells (CELL_MM included) and kmax in {-1, 0, 1, S}, with B and
    R one either side of the kernel's 128 x 128 tile, single and banked."""
    d = 4
    gen = torch.Generator(device=cuda).manual_seed(rows + b + s)
    cells = torch.randint(0, 4, (rows, d * s), device=cuda, generator=gen)
    is0 = ((cells == 0) | (cells == 3)).to(torch.uint8)
    is1 = ((cells == 1) | (cells == 3)).to(torch.uint8)
    is0[cells == 2], is1[cells == 2] = 0, 0
    x = torch.randint(0, 2, (b, d * s), device=cuda, generator=gen,
                      dtype=torch.uint8)
    choice = torch.tensor([-1, 0, 1, s], dtype=torch.int32, device=cuda)
    km = choice[torch.randint(0, 4, (rows, d), device=cuda, generator=gen)]
    km[:, 0] = s // 2 + 8          # most pairs reach division 1
    got = tk.tcam_match_cuda(x, is0, is1, km, s=s)
    want = tk.tcam_match_plain(x, is0, is1, s, km)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    xb, i0, i1, kb = (t[None].expand(3, *t.shape).contiguous()
                      for t in (x, is0, is1, km))
    got = tk.tcam_match_banked_cuda(xb, i0, i1, kb, s=s)
    for g, w in zip(got, want):
        assert torch.equal(g, w[None].expand_as(g))


@pytest.mark.gpu
def test_bitplane_kernel_divergent_warps(cuda):
    """Row 5 of every warp always matches (kmax = S) while its neighbours
    die in division 0 (kmax = -1); row 7 holds word 3's bits exactly
    (kmax = 0), and word b shares its first b % D divisions with word 3, so
    one word of the tile survives while the others die, each in its own
    division."""
    s, d, b, r = 32, 6, 2 * TILE + 3, 2 * TILE + 9
    gen = torch.Generator(device=cuda).manual_seed(7)
    base = torch.randint(0, 2, (d * s,), device=cuda, generator=gen,
                         dtype=torch.uint8)
    x = torch.randint(0, 2, (b, d * s), device=cuda, generator=gen,
                      dtype=torch.uint8)
    x[:, 0] = 1 - base[0]                    # every word differs in division 0
    for i in range(b):
        keep = (i % d) * s
        x[i, :keep] = base[:keep]
        if keep < d * s:
            x[i, keep] = 1 - base[keep]       # and differs where its prefix ends
    x[3] = base
    lane = torch.arange(r, device=cuda) % 32
    is0 = torch.zeros((r, d * s), dtype=torch.uint8, device=cuda)
    is1 = torch.zeros_like(is0)
    is0[lane == 7] = (base == 0).to(torch.uint8)
    is1[lane == 7] = base
    km = torch.full((r, d), -1, dtype=torch.int32, device=cuda)
    km[lane == 5] = s
    km[lane == 7] = 0
    survive, evals = tk.tcam_match_cuda(x, is0, is1, km, s=s)
    want = tk.tcam_match_plain(x, is0, is1, s, km)
    assert torch.equal(survive, want[0]) and torch.equal(evals, want[1])
    words = torch.arange(b, device=cuda)
    expect_ev = torch.where(words == 3, d, words % d + 1).to(torch.int32)
    assert torch.equal(evals[:, lane == 7], expect_ev[:, None].expand(
        b, int((lane == 7).sum())))
    assert torch.equal(survive[:, lane == 7].sum(0),
                       torch.ones(int((lane == 7).sum()), dtype=torch.int64,
                                  device=cuda))
    assert bool((survive[:, lane == 5] == 1).all())
    assert bool((evals[:, lane == 5] == d).all())
    other = (lane != 5) & (lane != 7)
    assert bool((survive[:, other] == 0).all())
    assert bool((evals[:, other] == 1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("w,s,path", [(4992, 128, "tiled"),    # credit tree
                                      (2048, 128, "tiled"),    # forest group 1
                                      (4096, 128, "tiled"),    # forest group 2
                                      (320, 16, "tiled"),
                                      (480, 160, "any"),
                                      (512, 256, "any")])
def test_bitplane_kernel_path_by_division_width(cuda, w, s, path):
    rows, b = 300, 200
    x, is0, is1, km = _kernel_operands(rows, w - 1, s, b, "mixed", True, cuda)
    assert x.shape[1] == w
    planes, kt = _prepacked(x, is0, is1, km, s)
    before = dict(tk.MATCH_PATH_LAUNCHES)
    got = tk.tcam_match_bits_cuda(x, planes, kt, s=s)
    torch.cuda.synchronize()
    assert tk.MATCH_PATH_LAUNCHES[path] == before[path] + 1
    other = "any" if path == "tiled" else "tiled"
    assert tk.MATCH_PATH_LAUNCHES[other] == before[other]
    for g, w_ in zip(got, tk.tcam_match_plain(x, is0, is1, s, km)):
        assert torch.equal(g, w_)


@pytest.mark.gpu
def test_banked_prepacked_entry_equals_uint8_entry(cuda):
    x, is0, is1, km = _banked_operands(1000, 500, 128, 300, 3, "mixed", cuda)
    planes = tk.pack_planes_cuda(is0, is1, s=128)
    before = tk.tcam_match_banked_bits_cuda.launches
    got = tk.tcam_match_banked_bits_cuda(x, planes,
                                         km.transpose(1, 2).contiguous(),
                                         s=128)
    torch.cuda.synchronize()
    assert tk.tcam_match_banked_bits_cuda.launches == before + 1
    for g, w in zip(got, tk.tcam_match_banked_cuda(x, is0, is1, km, s=128)):
        assert torch.equal(g, w)


# -- the packed kernel on division-major operands ---------------------------
PACKED_SWEEP = ([c for c in SWEEP if c[2] % 32 == 0]
                + [(1000, 500, 128, 300), (70, 300, 96, 40)])


def _packed_operands(x, is0, is1, km, s):
    """vc = (val, care) words packed on the card, and kmax transposed."""
    return (tk.pack_planes_cuda(is1[None], (is0 | is1)[None], s=s)[0],
            km.t().contiguous())


def _packed_plain(x, vc, kt, s):
    return tk.tcam_match_packed_bits_ref(tk.pack_words(x[None], s)[0], vc, kt,
                                         x.shape[0])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["zero", "pos", "mixed", "masked"])
@pytest.mark.parametrize("rows,width,s,b", PACKED_SWEEP)
def test_packed_prepacked_entry_equals_plain_on_card(cuda, rows, width, s, b,
                                                     kind):
    x, is0, is1, km = _kernel_operands(rows, width, s, b, kind, False, cuda)
    vc, kt = _packed_operands(x, is0, is1, km, s)
    before = (tk.tcam_match_packed_bits_cuda.launches,
              tk.pack_words_cuda.launches, tk.tcam_match_packed_cuda.launches)
    got = tk.tcam_match_packed_bits_cuda(x, vc, kt, s=s)
    torch.cuda.synchronize()
    assert (tk.tcam_match_packed_bits_cuda.launches,
            tk.pack_words_cuda.launches,
            tk.tcam_match_packed_cuda.launches) == (before[0] + 1,
                                                    before[1] + 1, before[2])
    for g, w in zip(got, _packed_plain(x, vc, kt, s)):
        assert torch.equal(g, w)
    xq, val, care = (tk.pack_bits(t) for t in (x, is1, is0 | is1))
    for g, w in zip(got, tk.tcam_match_packed_plain(xq, val, care, s, km)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [32, 128])
@pytest.mark.parametrize("b", [63, 64, 65])
@pytest.mark.parametrize("rows", [127, 128, 129])
def test_packed_kernel_at_tile_edges(cuda, rows, b, s):
    """Random cells and kmax in {-1, 0, 1, S}, with B and R at and one either
    side of the packed kernel's 128-row x 64-word tile."""
    d = 4
    gen = torch.Generator(device=cuda).manual_seed(rows + b + s)
    cells = torch.randint(0, 3, (rows, d * s), device=cuda, generator=gen)
    is0 = (cells == 0).to(torch.uint8)
    is1 = (cells == 1).to(torch.uint8)
    x = torch.randint(0, 2, (b, d * s), device=cuda, generator=gen,
                      dtype=torch.uint8)
    choice = torch.tensor([-1, 0, 1, s], dtype=torch.int32, device=cuda)
    km = choice[torch.randint(0, 4, (rows, d), device=cuda, generator=gen)]
    km[:, 0] = s // 2 + 8          # most pairs reach division 1
    vc, kt = _packed_operands(x, is0, is1, km, s)
    got = tk.tcam_match_packed_bits_cuda(x, vc, kt, s=s)
    want = _packed_plain(x, vc, kt, s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(torch.unique(want[1])) >= 3     # pairs die in several divisions


@pytest.mark.gpu
def test_packed_kernel_warp_of_mixed_tests(cuda):
    """Within each warp, lane l % 4 picks the row's test in every division
    after the first: 0 kmax -1 (never), 1 kmax 0 (the OR test), 2 kmax 2
    (the popcount sum), 3 an all-don't-care division (always, no word
    loads).  Rows hold word (l % 8)'s bits with a few cells flipped, so
    pairs die in many divisions."""
    s, d, b, r = 64, 6, 2 * 64 + 5, 2 * 128 + 3
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randint(0, 2, (b, d * s), device=cuda, generator=gen,
                      dtype=torch.uint8)
    lane = torch.arange(r, device=cuda) % 32
    bits = x[lane % 8].clone()
    flip = torch.rand((r, d * s), device=cuda, generator=gen) < 0.01
    bits[flip] ^= 1
    is1 = bits
    is0 = 1 - bits
    km = torch.zeros((r, d), dtype=torch.int32, device=cuda)
    km[lane % 4 == 2, 1:] = 2
    never = (lane % 4 == 0) & (torch.arange(r, device=cuda) % 3 == 0)
    km[never, 3] = -1
    blank = lane % 4 == 3
    is0[blank, s:3 * s] = 0
    is1[blank, s:3 * s] = 0
    vc, kt = _packed_operands(x, is0, is1, km, s)
    survive, evals = tk.tcam_match_packed_bits_cuda(x, vc, kt, s=s)
    want = _packed_plain(x, vc, kt, s)
    assert torch.equal(survive, want[0]) and torch.equal(evals, want[1])
    assert len(torch.unique(evals)) == d and 0 < int(survive.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["zero", "mixed"])
@pytest.mark.parametrize("s,b", [(32, 200), (96, 65), (128, 130)])
def test_packed_kernel_repeated_words(cuda, s, b, kind):
    """Search words drawn from a few values per division, as encoded
    queries are: the kernel tests one word of each class of equal words in
    a tile and applies the result to the class."""
    d, rows = 5, 300
    gen = torch.Generator(device=cuda).manual_seed(s + b)
    pool = torch.randint(0, 2, (4, d * s), device=cuda, generator=gen,
                         dtype=torch.uint8)
    pick = torch.randint(0, 4, (b, d), device=cuda, generator=gen)
    x = torch.gather(pool, 0, pick.repeat_interleave(s, 1))
    rowpick = torch.randint(0, 4, (rows, d), device=cuda, generator=gen)
    bits = torch.gather(pool, 0, rowpick.repeat_interleave(s, 1))
    keep = torch.rand((rows, d * s), device=cuda, generator=gen) < 0.5
    is1 = (bits & keep).to(torch.uint8)
    is0 = ((1 - bits) & keep).to(torch.uint8)
    km = torch.zeros((rows, d), dtype=torch.int32, device=cuda)
    if kind == "mixed":
        km = torch.randint(-1, 3, (rows, d), device=cuda, generator=gen,
                           dtype=torch.int32)
    vc, kt = _packed_operands(x, is0, is1, km, s)
    got = tk.tcam_match_packed_bits_cuda(x, vc, kt, s=s)
    want = _packed_plain(x, vc, kt, s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < int(want[0].sum()) < b * rows


@pytest.mark.gpu
@pytest.mark.parametrize("w,s,path", [(4992, 128, "tiled"),    # credit tree
                                      (384, 96, "tiled"),
                                      (320, 32, "tiled"),
                                      (480, 160, "any"),
                                      (512, 256, "any")])
def test_packed_kernel_path_by_division_width(cuda, w, s, path):
    x, is0, is1, km = _kernel_operands(300, w - 1, s, 200, "mixed", False,
                                       cuda)
    assert x.shape[1] == w
    vc, kt = _packed_operands(x, is0, is1, km, s)
    before = dict(tk.PACKED_PATH_LAUNCHES)
    bitplane = dict(tk.MATCH_PATH_LAUNCHES)
    got = tk.tcam_match_packed_bits_cuda(x, vc, kt, s=s)
    torch.cuda.synchronize()
    assert tk.PACKED_PATH_LAUNCHES[path] == before[path] + 1
    other = "any" if path == "tiled" else "tiled"
    assert tk.PACKED_PATH_LAUNCHES[other] == before[other]
    assert tk.MATCH_PATH_LAUNCHES == bitplane
    for g, w_ in zip(got, _packed_plain(x, vc, kt, s)):
        assert torch.equal(g, w_)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,width,s,b", PACKED_SWEEP)
def test_row_major_packed_entry_equals_prepacked_entry(cuda, rows, width, s,
                                                       b):
    x, is0, is1, km = _kernel_operands(rows, width, s, b, "mixed", False,
                                       cuda)
    vc, kt = _packed_operands(x, is0, is1, km, s)
    xq, val, care = (tk.pack_bits(t) for t in (x, is1, is0 | is1))
    before = tk.tcam_match_packed_bits_cuda.launches
    got = tk.tcam_match_packed_cuda(xq, val, care, km, s=s)
    assert tk.tcam_match_packed_bits_cuda.launches == before
    for g, w in zip(got, tk.tcam_match_packed_bits_cuda(x, vc, kt, s=s)):
        assert torch.equal(g, w)
