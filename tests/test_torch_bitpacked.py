"""The bitplane kernel's bit-packed, division-major operands against the JAX
package, bit for bit: the plain version of the packed arithmetic
(``ref.tcam_match_bits_ref`` on ``pack_words`` / ``pack_planes`` / kmax
transposed) equals ``tcam_match_pallas(..., interpret=True)`` and
``tcam_match_ref``; the packing round-trips; and ``prepare_match`` /
``prepare_banked(engine="mxu")`` on the CPU give operands whose
``run_match`` / ``run_banked`` equal the JAX package.  No tolerance: every
comparison is ``equal`` on int32.  ``test_torch_cuda.py`` holds the CUDA
kernels against these plain versions on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
import repro.kernels.banked as jbanked
from repro.core.lut import bitplanes
from repro.kernels.tcam_match import tcam_match_pallas
from repro_torch import kernels as tk
from test_kernels import SWEEP, _random_layout
from test_torch_cuda import banked_group
from test_torch_kernels import _kmax

KINDS = ["zero", "pos", "mixed", "masked"]


def _layout_case(rows, width, s, b, kind, with_mm):
    rng = np.random.default_rng(rows * 11 + s + with_mm)
    lay = _random_layout(rng, rows, width, s, with_mm=with_mm)
    xp = lay.pad_inputs(rng.integers(0, 2, size=(b, width)).astype(np.uint8))
    return lay, xp, _kmax(rng, lay, kind)


def _bits_plain(xp, is0, is1, km, s):
    """The packed-operand plain version on numpy (B, W), (R, W), (R, D)."""
    t = (torch.from_numpy(a) for a in (xp, is0, is1, km))
    x, p0, p1, k = t
    return tk.tcam_match_bits_ref(tk.pack_words(x, s), tk.pack_planes(p0, p1, s),
                                  k.t().contiguous(), x.shape[0])


def _pad(a, axis, mult, value=0):
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, -a.shape[axis] % mult)
    return np.pad(a, widths, constant_values=value)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_mm", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows,width,s,b", SWEEP)
def test_bits_plain_equals_pallas_interpret_and_jax_ref(rows, width, s, b,
                                                        kind, with_mm):
    lay, xp, km = _layout_case(rows, width, s, b, kind, with_mm)
    is0, is1 = bitplanes(lay.cells)
    got = _bits_plain(xp, is0, is1, km, s)
    r = is0.shape[0]
    pallas = tcam_match_pallas(
        jnp.asarray(_pad(xp, 0, 128)), jnp.asarray(_pad(is0, 0, 128)),
        jnp.asarray(_pad(is1, 0, 128)), jnp.asarray(_pad(km, 0, 128, -1)),
        s=s, interpret=True)
    _assert_equal(got, [np.asarray(p)[:b, :r] for p in pallas])
    _assert_equal(got, jk.tcam_match_ref(jnp.asarray(xp), jnp.asarray(is0),
                                         jnp.asarray(is1), s, jnp.asarray(km)))


@pytest.mark.parametrize("kind", KINDS)
def test_bits_plain_on_three_unequal_banks_equals_jax_banked_mxu(kind):
    cells, xpad, kmax = banked_group(120, 123, 64, 130, 3, kind=kind)
    is0, is1 = (torch.from_numpy(p) for p in bitplanes(cells))
    x = torch.from_numpy(xpad)
    got = tk.tcam_match_bits_ref(
        tk.pack_words(x, 64), tk.pack_planes(is0, is1, 64),
        torch.from_numpy(kmax).transpose(1, 2).contiguous(), x.shape[1])
    want = jbanked.tcam_match_banked(cells, jnp.asarray(xpad), 64,
                                     jnp.asarray(kmax), engine="mxu",
                                     interpret=True)
    _assert_equal(got, want)


def _unpack(words, s):
    """(..., D, SW) int32 -> (..., D·s) {0,1}: the inverse of
    ``pack_divisions``, which also checks that the pad bits are zero."""
    bits = (words[..., None] >> torch.arange(32, dtype=torch.int32)) & 1
    bits = bits.reshape(*words.shape[:-1], -1)
    assert not bool(bits[..., s:].any()), "pad bits must be zero"
    return bits[..., :s].reshape(*words.shape[:-2], -1)


@pytest.mark.parametrize("s", [16, 24, 32, 64, 96, 128, 160])
def test_packing_round_trips(s):
    rng = np.random.default_rng(s)
    g, b, r, d = 2, 7, 5, 3
    x = torch.from_numpy(rng.integers(0, 2, (g, b, d * s)).astype(np.uint8))
    p0 = torch.from_numpy(rng.integers(0, 2, (g, r, d * s)).astype(np.uint8))
    p1 = torch.from_numpy(rng.integers(0, 2, (g, r, d * s)).astype(np.uint8))
    sw = tk.words_per_division(s)
    xw = tk.pack_words(x, s)
    assert xw.shape == (g, d, 8, sw) and xw.dtype == torch.int32
    assert not bool(xw[:, :, b:].any()), "pad words must be zero"
    assert torch.equal(_unpack(xw[:, :, :b].transpose(1, 2), s), x.int())
    planes = tk.pack_planes(p0, p1, s)
    assert planes.shape == (g, d, r, 2 * sw)
    rows = planes.transpose(1, 2)                      # (g, r, d, 2·SW)
    assert torch.equal(_unpack(rows[..., :sw], s), p0.int())
    assert torch.equal(_unpack(rows[..., sw:], s), p1.int())
    if s % 32 == 0:
        want = jk.pack_bits(jnp.asarray(x.numpy()))
        got = xw[:, :, :b].transpose(1, 2).reshape(g, b, d * sw)
        np.testing.assert_array_equal(got.numpy().astype(np.int64) & 0xFFFFFFFF,
                                      np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("with_mm", [False, True])
@pytest.mark.parametrize("rows,width,s,b", SWEEP)
def test_prepare_match_mxu_on_cpu_equals_jax(rows, width, s, b, with_mm):
    lay, xp, km = _layout_case(rows, width, s, b, "mixed", with_mm)
    ops = tk.prepare_match(lay.cells, s, km, engine="mxu", device="cpu")
    assert ops.a.shape == (lay.n_cwd, lay.cells.shape[0],
                           2 * tk.words_per_division(s))
    assert ops.b is None and ops.kmax.shape == (lay.n_cwd, lay.cells.shape[0])
    got = tk.run_match(ops, torch.from_numpy(xp))
    _assert_equal(got, jk.tcam_match(lay.cells, xp, s, jnp.asarray(km),
                                      engine="mxu"))


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("rows,width,s,b", SWEEP)
def test_prepare_banked_mxu_on_cpu_equals_jax(rows, width, s, b, g):
    cells, xpad, kmax = banked_group(rows, width, s, b, g)
    ops = tk.prepare_banked(cells, s, kmax, engine="mxu", device="cpu")
    assert ops.a.shape[:3] == (g, cells.shape[2] // s, cells.shape[1])
    got = tk.run_banked(ops, torch.from_numpy(xpad))
    _assert_equal(got, jbanked.tcam_match_banked(
        cells, jnp.asarray(xpad), s, jnp.asarray(kmax), engine="mxu",
        interpret=True))


def test_bits_entries_check_their_arguments():
    x = torch.zeros((2, 4, 64), dtype=torch.uint8)
    planes = torch.zeros((2, 2, 8, 2), dtype=torch.int32)
    kt = torch.zeros((2, 2, 8), dtype=torch.int32)
    out = tk.tcam_match_banked_bits_cuda(x, planes, kt, s=32)
    assert out[0].shape == (2, 4, 8)
    with pytest.raises(ValueError, match="planes shape"):
        tk.tcam_match_banked_bits_cuda(x, planes[:, :1].contiguous(), kt, s=32)
    with pytest.raises(ValueError, match="kmax_t shape"):
        tk.tcam_match_banked_bits_cuda(x, planes, kt[:, :, :4].contiguous(),
                                       s=32)
    with pytest.raises(TypeError, match="int32"):
        tk.tcam_match_bits_cuda(x[0], planes[0].long(), kt[0], s=32)
    with pytest.raises(ValueError, match="multiple"):
        tk.tcam_match_bits_cuda(x[0], planes[0], kt[0], s=48)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.tcam_match_bits_cuda(x[0].to("meta"), planes[0].to("meta"),
                                kt[0].to("meta"), s=32)
