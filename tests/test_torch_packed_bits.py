"""The packed kernel's division-major operands against the JAX package, bit
for bit: the plain version of its arithmetic (``ref.tcam_match_packed_bits_ref``
on ``pack_words`` / ``vc = pack_planes(is1, is0 | is1)`` / kmax
transposed) equals ``repro.kernels.tcam_match(..., engine="packed")``
(``tcam_match_packed_pallas`` in interpret mode) and ``tcam_match_packed_ref``;
``prepare_match(engine="packed")`` / ``run_match`` on the CPU equal the JAX
package; the row-major operands rearrange into the same format.  No
tolerance: every comparison is ``equal`` on int32.  ``test_torch_cuda.py``
holds the CUDA kernel against these plain versions on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.core.lut import CELL_X, bitplanes
from repro_torch import kernels as tk
from test_kernels import SWEEP, _random_layout
from test_torch_bitpacked import KINDS, _assert_equal, _layout_case

# The sweep's shapes with S % 32 == 0, and one wider than the tiled kernel.
SHAPES = [c for c in SWEEP if c[2] % 32 == 0] + [(70, 300, 160, 40)]


def _packed_bits_plain(xp, is0, is1, km, s):
    """The division-major plain version on numpy (B, W), (R, W), (R, D)."""
    x, p0, p1, k = (torch.from_numpy(a) for a in (xp, is0, is1, km))
    return tk.tcam_match_packed_bits_ref(
        tk.pack_words(x, s), tk.pack_planes(p1, p0 | p1, s),
        k.t().contiguous(), x.shape[0])


def _jax_packed_ref(xp, is0, is1, km, s):
    return jk.tcam_match_packed_ref(
        jk.pack_bits(jnp.asarray(xp)), jk.pack_bits(jnp.asarray(is1)),
        jk.pack_bits(jnp.asarray(is0 | is1)), s, jnp.asarray(km))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows,width,s,b", SHAPES)
def test_packed_bits_plain_equals_pallas_interpret_and_jax_ref(rows, width, s,
                                                               b, kind):
    lay, xp, km = _layout_case(rows, width, s, b, kind, False)
    is0, is1 = bitplanes(lay.cells)
    got = _packed_bits_plain(xp, is0, is1, km, s)
    _assert_equal(got, jk.tcam_match(lay.cells, xp, s, jnp.asarray(km),
                                     engine="packed"))
    _assert_equal(got, _jax_packed_ref(xp, is0, is1, km, s))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows,width,s,b", SHAPES)
def test_prepare_match_packed_on_cpu_equals_jax(rows, width, s, b, kind):
    lay, xp, km = _layout_case(rows, width, s, b, kind, False)
    ops = tk.prepare_match(lay.cells, s, km, engine="packed", device="cpu")
    r, d, sw = lay.cells.shape[0], lay.n_cwd, s // 32
    assert ops.engine == "packed" and ops.b is None
    assert ops.a.shape == (d, r, 2 * sw) and ops.a.dtype == torch.int32
    assert torch.equal(ops.kmax, torch.from_numpy(km).t())
    # vc holds, per (division, row), the row-major packed val then care words
    is0, is1 = (torch.from_numpy(p) for p in bitplanes(lay.cells))
    val, care = tk.pack_bits(is1), tk.pack_bits(is0 | is1)
    rows_major = ops.a.transpose(0, 1).reshape(r, d, 2, sw)
    assert torch.equal(rows_major[:, :, 0].reshape(r, -1), val)
    assert torch.equal(rows_major[:, :, 1].reshape(r, -1), care)
    got = tk.run_match(ops, torch.from_numpy(xp))
    _assert_equal(got, jk.tcam_match(lay.cells, xp, s, jnp.asarray(km),
                                     engine="packed"))


@pytest.mark.parametrize("s", [32, 128])
def test_all_dont_care_divisions_and_kmax_s(s):
    """Rows with whole divisions of don't-care cells (which match whenever
    kmax >= 0) and kmax = S in others, beside kmax -1, 0 and > 0: the cases
    the kernel decides without word loads."""
    rng = np.random.default_rng(s)
    lay = _random_layout(rng, 150, 5 * s - 1, s)
    cells = lay.cells.copy()
    r, d = cells.shape[0], lay.n_cwd
    blank = rng.random((r, d)) < 0.3
    blank[:, 0] = rng.random(r) < 0.5          # some rows blank in division 0
    for j in range(d):
        cells[blank[:, j], j * s:(j + 1) * s] = CELL_X
    km = rng.choice(np.array([-1, 0, 0, 0, 1, 3, s], np.int32), size=(r, d))
    km[::7, :] = s                             # rows that always match
    xb = rng.integers(0, 2, size=(97, lay.width)).astype(np.uint8)
    xp = lay.pad_inputs(xb)
    xp[:, 0] = 1
    is0, is1 = bitplanes(cells)
    got = _packed_bits_plain(xp, is0, is1, km, s)
    want = jk.tcam_match(cells, xp, s, jnp.asarray(km), engine="packed")
    _assert_equal(got, want)
    _assert_equal(got, _jax_packed_ref(xp, is0, is1, km, s))
    ops = tk.prepare_match(cells, s, km, engine="packed", device="cpu")
    _assert_equal(tk.run_match(ops, torch.from_numpy(xp)), want)
    survive, evals = (np.asarray(t) for t in want)
    assert survive[:, ::7].all() and (evals[:, ::7] == d).all()
    assert 0 < survive.sum() < survive.size


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows,width,s,b", SHAPES)
def test_row_major_operands_rearrange_to_division_major(rows, width, s, b,
                                                        kind):
    lay, xp, km = _layout_case(rows, width, s, b, kind, False)
    is0, is1 = (torch.from_numpy(p) for p in bitplanes(lay.cells))
    x = torch.from_numpy(xp)
    xq, val, care = tk.pack_bits(x), tk.pack_bits(is1), tk.pack_bits(is0 | is1)
    k = torch.from_numpy(km)
    xw, vc, kt = tk.packed_division_major(xq, val, care, k, s)
    assert torch.equal(xw, tk.pack_words(x, s))
    assert torch.equal(vc, tk.pack_planes(is1, is0 | is1, s))
    assert torch.equal(kt, k.t())
    got = tk.tcam_match_packed_bits_ref(xw, vc, kt, b)
    for g, w in zip(got, tk.tcam_match_packed_plain(xq, val, care, s, k)):
        assert torch.equal(g, w)
    for g, w in zip(got, tk.tcam_match_packed_cuda(xq, val, care, k, s=s)):
        assert torch.equal(g, w)


def test_packed_bits_entry_checks_its_arguments():
    x = torch.zeros((4, 128), dtype=torch.uint8)
    vc = torch.zeros((2, 8, 4), dtype=torch.int32)
    kt = torch.zeros((2, 8), dtype=torch.int32)
    survive, evals = tk.tcam_match_packed_bits_cuda(x, vc, kt, s=64)
    assert survive.shape == evals.shape == (4, 8)
    assert bool((survive == 1).all()) and bool((evals == 2).all())
    with pytest.raises(ValueError, match="S % 32"):
        tk.tcam_match_packed_bits_cuda(x, vc, kt, s=16)
    with pytest.raises(ValueError, match="vc shape"):
        tk.tcam_match_packed_bits_cuda(x, vc[:1].contiguous(), kt, s=64)
    with pytest.raises(ValueError, match="vc shape"):
        tk.tcam_match_packed_bits_cuda(x, vc[..., :2].contiguous(), kt, s=64)
    with pytest.raises(ValueError, match="kmax_t shape"):
        tk.tcam_match_packed_bits_cuda(x, vc, kt[:, :4].contiguous(), s=64)
    with pytest.raises(TypeError, match="int32"):
        tk.tcam_match_packed_bits_cuda(x, vc.long(), kt, s=64)
    with pytest.raises(TypeError, match="uint8"):
        tk.tcam_match_packed_bits_cuda(x.int(), vc, kt, s=64)
    with pytest.raises(ValueError, match="contiguous"):
        tk.tcam_match_packed_bits_cuda(x, vc.transpose(0, 1), kt, s=64)
    with pytest.raises(ValueError, match="multiple"):
        tk.tcam_match_packed_bits_cuda(x[:, :96].contiguous(), vc, kt, s=64)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.tcam_match_packed_bits_cuda(x.to("meta"), vc.to("meta"),
                                       kt.to("meta"), s=64)
