"""The port's TCAM match against the JAX package's, bit for bit: the plain
PyTorch oracles, every engine of ``tcam_match`` over the kernel sweep shapes,
the kmax corner cases and CELL_MM cells.  ``test_torch_cuda.py`` holds each
CUDA kernel against its plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.core.lut import CELL_MM, CELL_X, bitplanes
from repro_torch import kernels as tk
from repro_torch.kernels.ops import _finalize as t_finalize
from test_kernels import SWEEP, _random_layout


def _case(rows, width, s, b, *, with_mm=False, seed=0):
    rng = np.random.default_rng(rows * 7 + s + seed)
    lay = _random_layout(rng, rows, width, s, with_mm=with_mm)
    xb = rng.integers(0, 2, size=(b, width)).astype(np.uint8)
    return rng, lay, lay.pad_inputs(xb)


def _kmax(rng, lay, kind):
    """kmax of one kind: 'zero' (ideal), 'pos' (several survivors), 'mixed'
    (-1, 0 and >0 together) or 'masked' (last division fully masked, S)."""
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


def _assert_pair(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 128), (1, 32)])
def test_pack_bits_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    bits = rng.integers(0, 2, size=shape).astype(np.uint8)
    got = tk.pack_bits(torch.from_numpy(bits)).numpy().astype(np.int64)
    want = np.asarray(jk.pack_bits(jnp.asarray(bits))).astype(np.int64)
    np.testing.assert_array_equal(got & 0xFFFFFFFF, want)


def test_popcount32_counts_every_bit_pattern():
    rng = np.random.default_rng(3)
    words = rng.integers(-(2**31), 2**31, size=4096, dtype=np.int64)
    words[:4] = [0, -1, -(2**31), 2**31 - 1]
    got = tk.popcount32(torch.from_numpy(words.astype(np.int32))).numpy()
    want = [bin(int(w) & 0xFFFFFFFF).count("1") for w in words]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["zero", "pos", "mixed", "masked"])
@pytest.mark.parametrize("rows,width,s,b", SWEEP)
def test_ref_matches_jax_ref(rows, width, s, b, kind):
    rng, lay, xp = _case(rows, width, s, b, with_mm=True)
    km = _kmax(rng, lay, kind)
    is0, is1 = bitplanes(lay.cells)
    want = jk.tcam_match_ref(jnp.asarray(xp), jnp.asarray(is0),
                             jnp.asarray(is1), s, jnp.asarray(km))
    got = tk.tcam_match_ref(torch.from_numpy(xp), torch.from_numpy(is0),
                            torch.from_numpy(is1), s, torch.from_numpy(km))
    _assert_pair(got, want)


@pytest.mark.parametrize("kind", ["zero", "pos", "mixed", "masked"])
@pytest.mark.parametrize("rows,width,s,b",
                         [c for c in SWEEP if c[2] % 32 == 0])
def test_packed_ref_matches_jax_packed_ref(rows, width, s, b, kind):
    rng, lay, xp = _case(rows, width, s, b)
    km = _kmax(rng, lay, kind)
    is0, is1 = bitplanes(lay.cells)
    want = jk.tcam_match_packed_ref(
        jk.pack_bits(jnp.asarray(xp)), jk.pack_bits(jnp.asarray(is1)),
        jk.pack_bits(jnp.asarray(is0 | is1)), s, jnp.asarray(km))
    got = tk.tcam_match_packed_ref(
        tk.pack_bits(torch.from_numpy(xp)), tk.pack_bits(torch.from_numpy(is1)),
        tk.pack_bits(torch.from_numpy(is0 | is1)), s, torch.from_numpy(km))
    _assert_pair(got, want)


@pytest.mark.parametrize("engine", ["mxu", "packed", "ref"])
@pytest.mark.parametrize("rows,width,s,b", SWEEP)
def test_tcam_match_engines_match_jax(rows, width, s, b, engine):
    rng, lay, xp = _case(rows, width, s, b)
    km = _kmax(rng, lay, "mixed")
    if engine == "packed" and s % 32:
        with pytest.raises(ValueError):
            tk.tcam_match(lay.cells, xp, s, km, engine=engine, device="cpu")
        with pytest.raises(ValueError):
            jk.tcam_match(lay.cells, xp, s, jnp.asarray(km), engine=engine)
        return
    want = jk.tcam_match(lay.cells, xp, s, jnp.asarray(km), engine=engine)
    got = tk.tcam_match(lay.cells, xp, s, km, engine=engine, device="cpu")
    _assert_pair(got, want)


def test_kmax_corner_cases_by_hand():
    """One row per corner: kmax -1 never matches, 0 needs an exact match,
    > 0 tolerates that many mismatches, S on a fully masked division always
    matches."""
    s = 32
    cells = np.full((4, 2 * s), CELL_X, np.int8)
    cells[:, :4] = [0, 1, 1, 0]                    # division 0: '0110....'
    x = np.zeros((1, 2 * s), np.uint8)
    x[0, :4] = [0, 1, 1, 1]                        # one mismatch in division 0
    km = np.array([[-1, 0], [0, 0], [1, 0], [1, s]], np.int32)
    for engine in ("mxu", "packed", "ref"):
        surv, ev = tk.tcam_match(cells, x, s, km, engine=engine, device="cpu")
        np.testing.assert_array_equal(surv.numpy(), [[0, 0, 1, 1]])
        np.testing.assert_array_equal(ev.numpy(), [[1, 1, 2, 2]])


def test_cell_mm_needs_bitplane_kernel_and_matches_jax():
    rng, lay, xp = _case(20, 30, 32, 8, with_mm=True, seed=5)
    assert (lay.cells == CELL_MM).any()
    assert tk.select_engine(lay.cells, 32, "auto") == "mxu"
    with pytest.raises(ValueError):
        tk.tcam_match(lay.cells, xp, 32, engine="packed", device="cpu")
    want = jk.tcam_match(lay.cells, xp, 32, engine="auto")
    got = tk.tcam_match(lay.cells, xp, 32, engine="auto", device="cpu")
    _assert_pair(got, want)


@pytest.mark.parametrize("s", [16, 32, 64])
@pytest.mark.parametrize("with_mm", [False, True])
@pytest.mark.parametrize("engine", ["auto", "mxu", "packed", "ref", "bogus"])
def test_select_engine_legality_matches_jax(s, with_mm, engine):
    rng = np.random.default_rng(s)
    lay = _random_layout(rng, 10, 20, s, with_mm=with_mm)
    if with_mm:
        lay.cells[0, 1] = CELL_MM
    try:
        want = jk.select_engine(lay.cells, s, engine)
    except ValueError:
        with pytest.raises(ValueError):
            tk.select_engine(lay.cells, s, engine)
    else:
        assert tk.select_engine(lay.cells, s, engine) == want


def test_finalize_picks_first_of_several_survivors():
    rng, lay, xp = _case(50, 40, 32, 64, seed=9)
    km = np.full((lay.cells.shape[0], lay.n_cwd), lay.s, np.int32)  # all match
    km[::3] = -1
    surv, ev = tk.tcam_match(lay.cells, xp, 32, km, engine="ref", device="cpu")
    assert (surv.sum(dim=1) > 1).all()
    got = t_finalize(surv, ev, torch.from_numpy(lay.classes))
    want = jk.ops._finalize(jnp.asarray(surv.numpy()), jnp.asarray(ev.numpy()),
                            jnp.asarray(lay.classes))
    _assert_pair(got, want)
    assert (got[1].numpy() == 1).all()             # row 0 has kmax -1


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((4, 64), dtype=torch.uint8)
    p = torch.zeros((8, 64), dtype=torch.uint8)
    km = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.tcam_match_cuda(x.float(), p, p, km, s=32)
    with pytest.raises(ValueError):
        tk.tcam_match_cuda(x[:, ::2], p[:, ::2], p[:, ::2], km, s=16)
    with pytest.raises(ValueError):
        tk.tcam_match_cuda(x, p, p, km[:, :1], s=32)
    w = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.tcam_match_packed_cuda(w, w, w, km[:4], s=48)
    with pytest.raises(ValueError):
        tk.tcam_match_cuda(x.to("meta"), p.to("meta"), p.to("meta"),
                           km.to("meta"), s=32)
