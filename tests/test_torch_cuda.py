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

Drift on the card: the tensor readout equal to its copied numpy body, the
tensor margins within their tolerance of theirs (rows due equal), and a
drifting server that launches the bitplane kernel on a grid drift filled
with CELL_MM and the packed kernel after a full scrub, with every ``*_ref``
function of the port patched to raise.

The LM path on the card against the same port on the CPU: forward, prefill
and decode_step of the reduced attention, MoE, mamba-hybrid, rwkv and
encoder-decoder configs, the mamba and rwkv mixers with carried state, the
MoE layer and the TCAM router.  Training on the card against the same
port on the CPU: the loss and every gradient leaf of five reduced configs
in f32, a whole train step that leaves its input state intact, and a
checkpoint restored onto the card and onto the CPU; the data-parallel step
on a mesh of one card against the unsharded step.
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


# --------------------------------------------------------------------------
# chip health and lifecycle on the card
# --------------------------------------------------------------------------
def _fault(cells, p, seed):
    from repro_torch.core import apply_saf_mask, sample_saf
    mask = sample_saf(cells.shape, p, p, np.random.default_rng(seed))
    return apply_saf_mask(cells, mask)


@pytest.fixture(scope="module")
def iris_tree():
    from repro_torch.core import DT2CAM
    from repro_torch.dt import load_split
    Xtr, ytr, Xte, _ = load_split("iris")
    return DT2CAM(s=16, max_depth=5, spare_rows=24).fit(Xtr, ytr), Xtr, Xte


@pytest.mark.gpu
@pytest.mark.parametrize("p,seed", [(0.0, 0), (0.02, 1), (0.05, 2), (0.2, 3)])
def test_bist_on_card_equals_plain_version(cuda, iris_tree, p, seed):
    """The tensor BIST on the card against the per-row loop, on faulted
    layouts holding CELL_MM cells and rows whose readback word differs."""
    from repro_torch.reliability import run_bist, run_bist_ref
    lay = iris_tree[0].compiled.layout
    actual = _fault(lay.cells, p, seed)
    args = dict(used=1 + lay.width, n_rows=lay.n_rows)
    got = run_bist(actual, lay.cells, device=cuda, **args)
    want = run_bist_ref(actual, lay.cells, **args)
    np.testing.assert_array_equal(got.detected, want.detected)
    assert got.probes_run == want.probes_run
    if p >= 0.05:
        assert (actual == CELL_MM).any() and got.n_defective > 0


@pytest.mark.gpu
def test_bist_on_card_random_grids(cuda):
    from repro_torch.reliability import run_bist, run_bist_ref
    rng = np.random.default_rng(5)
    for _ in range(20):
        r, w = (int(v) for v in rng.integers(1, 40, 2))
        w += 1
        used = int(rng.integers(1, w + 1))
        intent = rng.integers(0, 4, (r, w)).astype(np.int8)
        actual = intent.copy()
        flip = rng.random((r, w)) < 0.2
        actual[flip] = rng.integers(0, 4, int(flip.sum()))
        got = run_bist(actual, intent, used=used, n_rows=r, device=cuda)
        want = run_bist_ref(actual, intent, used=used, n_rows=r)
        np.testing.assert_array_equal(got.detected, want.detected)
        assert got.probes_run == want.probes_run


@pytest.mark.gpu
@pytest.mark.parametrize("dataset,s,counter", [
    ("iris", 16, "tcam_match_bits_cuda"),            # S % 32 != 0: bitplane
    ("cancer", 32, "tcam_match_packed_bits_cuda"),   # auto = packed
])
def test_row_utilization_through_the_kernel(cuda, dataset, s, counter):
    import dataclasses

    from repro_torch.core import DT2CAM, encode_inputs
    from repro_torch.dt import load_split
    from repro_torch.reliability import row_utilization, row_utilization_ref
    Xtr, ytr, _, _ = load_split(dataset)
    m = DT2CAM(s=s, max_depth=8, spare_rows=8).fit(Xtr, ytr)
    lay = m.compiled.layout
    xb = encode_inputs(m.compiled.lut, Xtr)
    wrapper = getattr(tk, counter)
    before = wrapper.launches
    got = row_utilization(lay, xb, device=cuda)
    assert wrapper.launches == before + 1
    np.testing.assert_array_equal(got, row_utilization_ref(lay, xb))
    faulted = dataclasses.replace(lay, cells=_fault(lay.cells, 0.05, 0))
    np.testing.assert_array_equal(row_utilization(faulted, xb, device=cuda),
                                  row_utilization_ref(faulted, xb))


def _served_equals_tcam_infer(srv, lut, X):
    """A served batch against ``tcam_infer`` on the server's current layout
    with its engine and kmax, on the card."""
    from repro_torch.core import encode_inputs
    res = srv.serve(X)
    want = tk.tcam_infer(srv.live_layout, encode_inputs(lut, X),
                         kmax=srv._kmax, engine=srv.engine, device=srv.device)
    for f, arr in (("prediction", want.predictions),
                   ("survivor", want.survivors),
                   ("n_survivors", want.n_survivors),
                   ("active_evals", want.active_evals)):
        np.testing.assert_array_equal([getattr(r, f) for r in res], arr)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["auto", "mxu"])
def test_served_batch_after_repair_uses_the_repaired_grid(cuda, iris_tree,
                                                          engine):
    from repro_torch.core import NonIdealSpec
    from repro_torch.serve import ServeConfig, TCAMServer
    m, _, Xte = iris_tree
    srv = TCAMServer(m.compiled, nonideal=NonIdealSpec(p_sa0=0.05, p_sa1=0.05),
                     rng=np.random.default_rng(0), device=cuda,
                     config=ServeConfig(background=False, engine=engine,
                                        max_batch=64))
    _served_equals_tcam_infer(srv, m.compiled.lut, Xte)
    report = srv.repair()
    assert report.rows_repaired > 0
    assert srv.self_test().n_defective == 0 or report.degraded
    _served_equals_tcam_infer(srv, m.compiled.lut, Xte)
    srv.close()


@pytest.mark.gpu
@pytest.mark.parametrize("auto_repair", [False, True])
def test_breaker_on_card_stays_on_the_kernel(cuda, iris_tree, auto_repair):
    """On the card the breaker's ladder ends at FAILED on the kernel's
    engine: no batch moves to the plain version, every batch launches the
    kernel, and the kernel's canary equals the plain version's on the
    served grid."""
    from repro_torch.core import NonIdealSpec
    from repro_torch.serve import ServeConfig, TCAMServer
    m, _, Xte = iris_tree
    cfg = ServeConfig(background=False, engine="mxu", max_batch=16,
                      canary_every_batches=1, canary_size=64,
                      auto_repair=auto_repair)
    for seed in range(6):
        srv = TCAMServer(m.compiled, device=cuda, config=cfg,
                         nonideal=NonIdealSpec(p_sa0=0.05, p_sa1=0.05),
                         rng=np.random.default_rng(seed))
        if srv.run_canary() >= cfg.canary_threshold:
            srv.close()
            continue
        before = tk.tcam_match_bits_cuda.launches
        srv.serve(Xte)
        h = srv.health()
        assert h["breaker"]["trips"] >= 1 and h["engine"] == "mxu"
        assert h["state"] in ("repaired", "failed")
        assert h["breaker"]["recovery"] in (None, "repair")
        assert (tk.tcam_match_bits_cuda.launches - before
                >= srv.metrics()["batches"])
        lay, probe = srv.live_layout, srv._canary
        plain = tk.tcam_infer(lay, probe.words[:, 1:1 + lay.width],
                              engine="ref", device="cpu")
        assert srv.run_canary() == probe.accuracy(plain.predictions)
        srv.close()
        return
    pytest.fail("no seed produced a tripping chip at p=5%")


@pytest.mark.gpu
def test_served_batch_after_promote_and_rollback(cuda, iris_tree):
    from repro_torch.core import DT2CAM
    from repro_torch.dt import load_split
    from repro_torch.serve import ServeConfig, TCAMServer
    m, Xtr, Xte = iris_tree
    _, ytr, _, _ = load_split("iris")
    v2 = DT2CAM(s=16, max_depth=3, spare_rows=24).fit(Xtr, ytr)
    srv = TCAMServer(m.compiled, device=cuda,
                     config=ServeConfig(background=False, max_batch=64))
    _served_equals_tcam_infer(srv, m.compiled.lut, Xte)
    srv.stage(v2.compiled, mirror_fraction=1.0)
    srv.serve(Xte[:16])
    assert srv.promote(max_disagreement=1.0).promoted
    _served_equals_tcam_infer(srv, v2.compiled.lut, Xte)
    assert srv.rollback() == "reverted"
    _served_equals_tcam_infer(srv, m.compiled.lut, Xte)
    srv.close()


@pytest.fixture(scope="module")
def cancer_forest():
    from repro_torch.dt import load_split
    from repro_torch.forest import compile_forest, train_forest
    Xtr, ytr, Xte, _ = load_split("cancer")
    trees = train_forest(Xtr, ytr, n_trees=6, max_depth=6, seed=0)
    return compile_forest(trees, s=128, spare_rows=4), Xte


def _forest_reference(srv, forest, X):
    """Predictions, voting survivors and active evaluations of the forest
    server's current bank layouts (after repair), bank by bank on the CPU,
    spare rows mapped back to LUT rows."""
    from repro_torch.core import encode_inputs
    from repro_torch.forest import aggregate_votes
    Xp = forest.prepare_inputs(X)
    survivors = np.empty((forest.n_banks, len(X)), np.int32)
    hit = np.empty((forest.n_banks, len(X)), bool)
    active = np.empty((forest.n_banks, len(X)), np.int64)
    for i, bank in enumerate(forest.banks):
        r = tk.tcam_infer(srv._f_layouts[i], encode_inputs(bank.lut, Xp),
                          engine="ref", device="cpu")
        hit[i] = r.n_survivors > 0
        survivors[i] = np.where(hit[i], srv._f_row_map[i][r.survivors], -1)
        active[i] = r.active_evals
    en = srv._f_enabled
    preds, _ = aggregate_votes(forest, survivors, en)
    return preds, hit[en].sum(axis=0), active[en].sum(axis=0)


@pytest.mark.gpu
def test_forest_auto_on_card_launches_the_banked_kernel(cuda, cancer_forest):
    from repro_torch.forest import ForestExecutor, forest_infer_ref
    from repro_torch.serve import ServeConfig, TCAMServer
    forest, Xte = cancer_forest
    before = tk.tcam_match_banked_bits_cuda.launches
    ex = ForestExecutor(forest, device=cuda)
    assert ex.engine == "mxu"
    np.testing.assert_array_equal(ex.infer(Xte).predictions,
                                  forest_infer_ref(forest, Xte).predictions)
    assert tk.tcam_match_banked_bits_cuda.launches > before
    with TCAMServer(forest, device=cuda,
                    config=ServeConfig(background=False)) as srv:
        assert srv.engine == "mxu"
        before = tk.tcam_match_banked_bits_cuda.launches
        res = srv.serve(Xte[:32])
        assert tk.tcam_match_banked_bits_cuda.launches > before
    np.testing.assert_array_equal(
        [r.prediction for r in res],
        forest_infer_ref(forest, Xte[:32]).predictions)
    with pytest.warns(RuntimeWarning, match="falling back to 'mxu'"):
        srv = TCAMServer(forest, device=cuda,
                         config=ServeConfig(background=False, engine="packed"))
    assert srv.engine == "mxu"
    srv.close()


@pytest.mark.gpu
def test_forest_served_after_repair_uses_the_repaired_banks(cuda,
                                                            cancer_forest):
    from repro_torch.core import NonIdealSpec
    from repro_torch.serve import ServeConfig, TCAMServer
    forest, Xte = cancer_forest
    srv = TCAMServer(forest, nonideal=NonIdealSpec(p_sa0=0.01, p_sa1=0.01),
                     rng=np.random.default_rng(11), device=cuda,
                     config=ServeConfig(background=False, max_batch=64))
    assert srv.engine == "mxu"
    for _ in range(2):
        res = srv.serve(Xte[:64])
        preds, n_surv, active = _forest_reference(srv, forest, Xte[:64])
        np.testing.assert_array_equal([r.prediction for r in res], preds)
        np.testing.assert_array_equal([r.n_survivors for r in res], n_surv)
        np.testing.assert_array_equal([r.active_evals for r in res], active)
        if srv._repair_reports:
            break
        reports = srv.repair()
        assert sum(r.rows_repaired for r in reports) > 0
    srv.close()


# --------------------------------------------------------------------------
# drift, margins and scrub on the card
# --------------------------------------------------------------------------
DRIFT_KW = dict(nu=0.05, nu_sigma=0.02, retention_tau_s=2e6)


def _drift_grid(iris_tree, rng):
    """The iris layout stacked on 4096 random rows of its width."""
    cells = iris_tree[0].compiled.layout.cells
    extra = rng.integers(0, 4, (4096, cells.shape[1])).astype(np.int8)
    return np.concatenate([cells, extra])


@pytest.mark.gpu
@pytest.mark.parametrize("t", [0.0, 1e5, 1e6, 3e7])
def test_drift_readout_on_card_equals_plain_version(cuda, iris_tree, t):
    from repro_torch.core import DriftSpec, sample_drift
    rng = np.random.default_rng(3)
    cells = _drift_grid(iris_tree, rng)
    model = sample_drift(cells.shape, DriftSpec(read_disturb_s=5.0, **DRIFT_KW),
                         np.random.default_rng(0), device=cuda)
    ages = rng.uniform(0.0, t, cells.shape[0])
    reads = rng.integers(0, 1000, cells.shape[0])
    got = model.readout(cells, ages, reads)
    assert got.device.type == "cuda" and got.dtype == torch.int8
    want = model.readout_ref(cells, ages, reads)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if t == 0.0:
        np.testing.assert_array_equal(want, cells)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [0.0, 1e6, 3e7])
def test_layout_margins_on_card_within_tolerance(cuda, iris_tree, t):
    """rtol=1e-12, atol=1e-15: the card sums each division in numpy's
    order, but its exp may differ by an ulp; the rows due under the margin
    policy are equal, worst first, with every row flagged too (at t=0
    equal rows tie)."""
    import dataclasses

    from repro_torch.core import DriftSpec, sample_drift
    from repro_torch.degradation import (ScrubPolicy, ScrubScheduler,
                                         layout_margins, layout_margins_ref)
    rng = np.random.default_rng(4)
    lay = iris_tree[0].compiled.layout
    lay = dataclasses.replace(lay, cells=_drift_grid(iris_tree, rng))
    model = sample_drift(lay.cells.shape, DriftSpec(**DRIFT_KW),
                         np.random.default_rng(1), device=cuda)
    ages = rng.uniform(0.0, t, lay.cells.shape[0])
    got = layout_margins(lay, model, ages, 0)
    want = layout_margins_ref(lay, model, ages, 0)
    for f in ("margin_match", "margin_mismatch"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(got.v_ref, want.v_ref)
    for margin_v in (0.15, 1.0):
        sch = ScrubScheduler(lay.cells.shape[0],
                             policy=ScrubPolicy(margin_v=margin_v))
        np.testing.assert_array_equal(sch.due(got.margin),
                                      sch.due(want.margin))


@pytest.mark.gpu
def test_drift_server_on_card_runs_the_kernels_and_no_plain_version(
        cuda, monkeypatch):
    """A drifting server at S=32: fresh it serves on the packed kernel, aged
    (CELL_MM in the served grid) on the bitplane kernel, after a full scrub
    on the packed kernel again, and with every ``*_ref`` function of the
    port raising; its answers equal the plain version's afterwards."""
    import sys

    from repro_torch.core import (CELL_MM, DT2CAM, DriftModel, DriftSpec,
                                  NonIdealSpec, encode_inputs)
    from repro_torch.dt import load_split
    from repro_torch.serve import ServeConfig, TCAMServer
    Xtr, ytr, Xte, _ = load_split("iris")
    m = DT2CAM(s=32, max_depth=5).fit(Xtr, ytr)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch"):
            for attr in dir(mod):
                if attr.endswith("_ref") and callable(getattr(mod, attr)):
                    monkeypatch.setattr(mod, attr, refuse)
    for attr in ("growth_ref", "readout_ref", "cell_resistances_ref"):
        monkeypatch.setattr(DriftModel, attr, refuse)

    srv = TCAMServer(m.compiled, nonideal=NonIdealSpec(
        drift=DriftSpec(**DRIFT_KW)), rng=np.random.default_rng(0),
        device=cuda, config=ServeConfig(background=False, max_batch=64))
    packed, bits = tk.tcam_match_packed_bits_cuda, tk.tcam_match_bits_cuda
    assert srv.engine == "packed"
    p0 = packed.launches
    fresh = srv.serve(Xte)
    assert packed.launches > p0
    srv.advance_time(3e7)
    aged_layout = srv.live_layout
    assert (aged_layout.cells == CELL_MM).any() and srv.engine == "mxu"
    assert srv.margins().summary()["rows_negative"] > 0
    b0 = bits.launches
    aged = srv.serve(Xte)
    assert bits.launches > b0
    assert srv.scrub_now(force=True).n_refreshed == len(aged_layout.cells)
    assert srv.engine == "packed"
    p1 = packed.launches
    scrubbed = srv.serve(Xte)
    assert packed.launches > p1
    srv.close()
    monkeypatch.undo()

    xb = encode_inputs(m.compiled.lut, Xte)
    for res, lay in ((fresh, m.compiled.layout), (aged, aged_layout),
                     (scrubbed, m.compiled.layout)):
        want = tk.tcam_infer(lay, xb, engine="ref", device="cpu")
        for f, arr in (("prediction", want.predictions),
                       ("survivor", want.survivors),
                       ("n_survivors", want.n_survivors),
                       ("active_evals", want.active_evals)):
            np.testing.assert_array_equal([getattr(r, f) for r in res], arr)


# ---------------------------------------------------------------------------
# the LM serving path: the card against the same port on the CPU
# ---------------------------------------------------------------------------
LM_BF16 = dict(rtol=5e-2, atol=5e-2)   # bf16 logits, as the CPU parity tests


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "gemma_7b",
                                  "jamba_v01_52b", "rwkv6_1p6b",
                                  "whisper_small"])
def test_lm_on_card_equals_cpu(cuda, arch):
    """forward, prefill and decode_step of a reduced config on the card
    equal the port on the CPU with the same weights and tokens (whisper's
    frames too); the card's own init runs there too."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import make_batch
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, param_count, prefill)
    cfg = get_reduced(arch)
    cpu = torch.device("cpu")
    p_cpu = init_params(cfg, 0, device=cpu)
    p_gpu = _to(p_cpu, cuda)
    mine = init_params(cfg, 0, device=cuda)
    assert param_count(mine) == param_count(p_cpu)
    assert all(v.is_cuda for v in mine["blocks"][cfg.pattern[0]].values())
    batch = make_batch(cfg, 2, 17, step=0)
    toks = batch["tokens"]
    kw = {"frames": batch["frames"]} if cfg.is_encdec else {}
    outs = []
    for dev, p in ((cpu, p_cpu), (cuda, p_gpu)):
        full = forward(p, cfg, toks, **kw)
        caches = init_cache(cfg, 2, 24, device=dev)
        last, caches = prefill(p, cfg, toks[:, :-1], caches, **kw)
        dec, caches = decode_step(p, cfg, toks[:, -1:], caches, 16)
        assert full.device.type == dev.type and dec.device.type == dev.type
        outs.append([t.float().cpu().numpy() for t in (full, last, dec)]
                    + [c["slot_pos"].cpu().numpy() for c in caches.values()
                       if "slot_pos" in c])
    (want, got) = outs
    for g, w in zip(got[:3], want[:3]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **LM_BF16)
    assert len(got) == len(want)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mamba+mlp", "rwkv+cmix"])
def test_recurrent_mixers_on_card_equal_cpu(cuda, kind):
    """The chunked mixer (and rwkv's channel mix) of one reduced layer on
    the card, f32, with carried state, against the same call on the CPU,
    at the WKV tolerance of the CPU parity tests (1e-4)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params, mamba, rwkv
    arch = "jamba_v01_52b" if kind == "mamba+mlp" else "rwkv6_1p6b"
    cfg = get_reduced(arch)
    p = {k: v[0] for k, v in init_params(
        cfg, 5, device="cpu")["blocks"][kind].items()}
    pg = _to(p, cuda)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    if kind == "mamba+mlp":
        state = (torch.from_numpy(rng.standard_normal(
            (2, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(
                (2, cfg.d_inner, cfg.ssm_state)).astype(np.float32)))
        calls = [lambda x, p, st: mamba.mamba_mixer(x, p, cfg, state=st,
                                                    return_state=True)]
    else:
        h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
        state = (torch.from_numpy(rng.standard_normal(
            (2, cfg.d_model)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(
                (2, h, hd, hd)).astype(np.float32)))
        calls = [lambda x, p, st: rwkv.rwkv_mixer(x, p, cfg, state=st,
                                                  return_state=True),
                 lambda x, p, st: rwkv.rwkv_channel_mix(
                     x, p, cfg, state=st[0], return_state=True)]
    for call in calls:
        want = call(x, p, state)
        got = call(x.to(cuda), pg, tuple(t.to(cuda) for t in state))
        flat_w = [want[0], *(want[1] if isinstance(want[1], tuple)
                             else (want[1],))]
        flat_g = [got[0], *(got[1] if isinstance(got[1], tuple)
                            else (got[1],))]
        for g, w in zip(flat_g, flat_w):
            assert g.is_cuda
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("groups,cf", [(1, 8.0), (2, 8.0), (1, 0.25)])
def test_moe_ffn_on_card_equals_cpu(cuda, groups, cf):
    from repro_torch.models import init_params, moe
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=2, head_dim=8, d_ff=32,
                      vocab_size=64, pattern=("attn+moe",), n_experts=4,
                      experts_per_token=2, moe_d_ff=32, moe_groups=groups,
                      capacity_factor=cf)
    p = {k: v[0] for k, v in init_params(
        cfg, 3, device="cpu")["blocks"]["attn+moe"].items()}
    pg = _to(p, cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, 16)).astype(np.float32))
    xg = x.to(cuda)
    _, top_cpu = moe.route(x.reshape(-1, 16), p, cfg)
    _, top_gpu = moe.route(xg.reshape(-1, 16), pg, cfg)
    assert torch.equal(top_gpu.cpu(), top_cpu)
    pos_cpu = moe._positions_in_expert(top_cpu.reshape(-1), 4)
    pos_gpu = moe._positions_in_expert(top_gpu.reshape(-1), 4)
    assert torch.equal(pos_gpu.cpu(), pos_cpu)
    np.testing.assert_allclose(moe.moe_ffn(xg, pg, cfg).cpu().numpy(),
                               moe.moe_ffn(x, p, cfg).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_route_tcam_on_card_equals_predict(cuda):
    from repro_torch.core import predict, train_tree
    from repro_torch.models.tcam_router import compile_router, route_tcam
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2000, 16))
    y = ((X[:, 0] > 0) * 2 + (X[:, 1] > 0.5) + 4 * (X[:, 2] > 1)).astype(
        np.int64)
    tree = train_tree(X, y, max_depth=8)
    bits = compile_router(tree, device=cuda)
    assert all(t.is_cuda for t in bits.values())
    Xt = rng.standard_normal((5000, 16)).astype(np.float32)
    got = route_tcam(torch.from_numpy(Xt).to(cuda), bits)
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), predict(tree, Xt))


# ---------------------------------------------------------------------------
# training: the card against the same port on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo_1b", "qwen3_moe_235b_a22b",
                                  "jamba_v01_52b", "rwkv6_1p6b",
                                  "whisper_small"])
def test_train_on_card_equals_cpu(cuda, arch):
    """``loss_fn``'s loss and every gradient leaf of a reduced config on
    the card equal the port's on the CPU, in f32 compute (loss within
    1e-5 relative, each leaf within 1e-4 of its largest |g|, as the CPU
    parity tests hold the port to the JAX package); then one whole train
    step on the card leaves finite params and its input state untouched."""
    from unittest import mock

    from repro_torch.configs import get_reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params, lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.pytree import tree_leaves
    from repro_torch.train import (accumulate_grads, build_train_step,
                                   init_train_state)
    cfg = get_reduced(arch)
    cpu = torch.device("cpu")
    batch = TokenPipeline(cfg, 4, 32, seed=0).batch_at(0)
    p_cpu = init_params(cfg, 0, device=cpu)
    with mock.patch.object(lm, "COMPUTE_DTYPE", torch.float32):
        g_cpu, m_cpu = accumulate_grads(cfg, p_cpu, batch)
        g_gpu, m_gpu = accumulate_grads(cfg, _to(p_cpu, cuda), batch)
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) <= 1e-5 * abs(
        float(m_cpu["loss"]))
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
        assert a.is_cuda
        top = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * top
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    state = init_train_state(cfg, 0, opt_cfg=opt, device=cuda)
    before = [t.clone() for t in tree_leaves(state)]
    new, m = build_train_step(cfg, opt, accum=2, compress=False)(state,
                                                                 batch)
    assert np.isfinite(float(m["loss"])) and int(new.opt.step) == 1
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), before))


@pytest.mark.gpu
def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A checkpoint restores onto the device of the state it is given:
    saved from the card, restored onto the card and onto the CPU, bit for
    bit, bf16 moments included."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.optim import AdamWConfig
    from repro_torch.pytree import tree_leaves
    from repro_torch.train import init_train_state
    cfg = get_reduced("olmo_1b")
    opt = AdamWConfig(mu_dtype="bfloat16", nu_dtype="bfloat16")
    state = init_train_state(cfg, 3, compress=True, opt_cfg=opt, device=cuda)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state)
    for dev in (cuda, torch.device("cpu")):
        like = init_train_state(cfg, 0, compress=True, opt_cfg=opt,
                                device=dev)
        got, step = mgr.restore(like, verify_crc=True)
        assert step == 4
        for a, b in zip(tree_leaves(got), tree_leaves(state)):
            assert a.device.type == dev.type and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
def test_mesh_of_one_on_card_equals_unsharded_step(cuda, tmp_path):
    """The data-parallel step on a mesh of one card (an NCCL process group
    of one) equals the unsharded step bit for bit over two steps, at
    olmo-1b's full width on 2 of its 16 layers, under PyTorch's
    deterministic algorithms (the embedding's backward adds with atomics
    otherwise); its state rests in ``DTensor``s."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import mesh_for_devices
    from repro_torch.optim import AdamWConfig
    from repro_torch.pytree import tree_leaves
    from repro_torch.sharding import make_rules
    from repro_torch.train import build_train_step, init_train_state
    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=2)
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    pipe = TokenPipeline(cfg, 2, 256, seed=0)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        rules = make_rules(mesh_for_devices(1), dp_only=True)
        out = []
        for r in (None, rules):
            state = init_train_state(cfg, 0, opt_cfg=opt, device=cuda,
                                     rules=r)
            step = build_train_step(cfg, opt, rules=r)
            losses = []
            for i in range(2):
                state, m = step(state, pipe.batch_at(i))
                losses.append(m["loss"])
            out.append(([t.full_tensor() if isinstance(t, DTensor) else t
                         for t in tree_leaves(state)], losses))
        assert isinstance(state.params["embed"], DTensor)
        (want, wl), (got, gl) = out
        assert all(torch.equal(a, b) for a, b in zip(wl, gl))
        assert len(got) == len(want)
        assert all(a.is_cuda and torch.equal(a, b)
                   for a, b in zip(got, want))
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
