"""The port's host pipeline and ``DT2CAM.infer(backend="torch")`` against the
JAX package, bit for bit: datasets, trees and layouts, registry blobs, and
every ``SimResult`` field on ideal and non-ideal hardware (equal seeds)."""
import dataclasses

import numpy as np
import pytest

import repro
import repro.dt as jdt
import repro_torch
import repro_torch.dt as tdt
from repro.core import DT2CAM as JaxDT2CAM
from repro.core import NonIdealSpec as JaxSpec
from repro.core import compile_tree as j_compile
from repro.core import train_tree as j_train
from repro_torch.convert import compiled_from_arrays
from repro_torch.core import DT2CAM, FeatureMismatch, NonIdealSpec
from repro_torch.core import compile_tree as t_compile
from repro_torch.core import train_tree as t_train

PAPER_DATASETS = ["iris", "cancer", "car"]
FIELDS = [f.name for f in dataclasses.fields(repro_torch.SimResult)]


def assert_same_result(got, want):
    """Every SimResult field equal: arrays elementwise, floats exactly."""
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


def _models(name, s):
    Xtr, ytr, Xte, yte = jdt.load_split(name)
    return (DT2CAM(s=s, max_depth=8).fit(Xtr, ytr),
            JaxDT2CAM(s=s, max_depth=8).fit(Xtr, ytr), Xte)


@pytest.mark.parametrize("name", sorted(jdt.DATASETS))
def test_datasets_equal_the_jax_package(name):
    for got, want in zip(tdt.load_split(name), jdt.load_split(name)):
        np.testing.assert_array_equal(got, want)
    assert tdt.DATASETS[name].max_leaves == jdt.DATASETS[name].max_leaves


@pytest.mark.parametrize("name", PAPER_DATASETS)
@pytest.mark.parametrize("s", [16, 128])
def test_train_and_compile_give_the_same_layout(name, s):
    spec = tdt.DATASETS[name]
    Xtr, ytr, _, _ = tdt.load_split(name)
    kw = dict(max_depth=spec.max_depth, max_leaves=spec.max_leaves,
              min_samples_leaf=spec.min_samples_leaf)
    got = t_compile(t_train(Xtr, ytr, **kw), s)
    want = j_compile(j_train(Xtr, ytr, **kw), s)
    for a in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(got.tree, a), getattr(want.tree, a))
    np.testing.assert_array_equal(got.lut.cells, want.lut.cells)
    np.testing.assert_array_equal(got.layout.cells, want.layout.cells)
    np.testing.assert_array_equal(got.layout.classes, want.layout.classes)
    for a in ("s", "n_rwd", "n_cwd", "n_rows", "width", "n_classes"):
        assert getattr(got.layout, a) == getattr(want.layout, a), a


def test_compiled_from_arrays_loads_a_published_blob(tmp_path):
    _, jm, Xte = _models("cancer", 32)
    reg = repro.ModelRegistry(str(tmp_path))
    v = reg.publish(jm.compiled, "cancer")
    path = tmp_path / (v.version_id.replace(":", "__") + ".npz")
    with np.load(path) as z:
        c = compiled_from_arrays(z)
    want = jm.compiled
    np.testing.assert_array_equal(c.layout.cells, want.layout.cells)
    np.testing.assert_array_equal(c.layout.class_bits, want.layout.class_bits)
    np.testing.assert_array_equal(c.table.th1, want.table.th1)
    for a, b in zip(c.lut.thresholds, want.lut.thresholds):
        np.testing.assert_array_equal(a, b)
    m = DT2CAM(s=32)
    m.compiled = c
    assert_same_result(m.infer(Xte, backend="torch", device="cpu"),
                       jm.infer(Xte, backend="jax"))


@pytest.mark.parametrize("name,s,engine", [
    ("iris", 16, "auto"), ("iris", 16, "mxu"), ("iris", 16, "ref"),
    ("cancer", 32, "auto"), ("cancer", 32, "packed"), ("car", 64, "mxu"),
])
def test_torch_backend_equals_jax_and_both_sims(name, s, engine):
    tm, jm, Xte = _models(name, s)
    got = tm.infer(Xte, backend="torch", engine=engine, device="cpu")
    assert_same_result(got, jm.infer(Xte, backend="jax", engine=engine))
    assert_same_result(got, jm.infer(Xte, backend="sim"))
    assert_same_result(got, tm.infer(Xte, backend="sim", device="cpu"))


@pytest.mark.parametrize("engine", ["auto", "mxu", "ref"])
@pytest.mark.parametrize("name,s", [("iris", 16), ("cancer", 32)])
def test_nonideal_results_equal_with_equal_seeds(name, s, engine):
    """Stuck faults, SA offsets and input noise drawn in the same order from
    equal seeds: the torch backend equals the JAX backend, and the port's
    numpy oracle equals the JAX package's."""
    tm, jm, Xte = _models(name, s)
    kw = dict(p_sa0=0.02, p_sa1=0.01, sa_sigma=0.03, sigma_in=0.04)

    def rng():
        return np.random.default_rng(7)

    got = tm.infer(Xte, backend="torch", engine=engine, device="cpu",
                   nonideal=NonIdealSpec(**kw), rng=rng())
    jspec = JaxSpec(**kw)
    assert_same_result(got, jm.infer(Xte, backend="jax", engine=engine,
                                     nonideal=jspec, rng=rng()))
    assert_same_result(tm.infer(Xte, nonideal=NonIdealSpec(**kw), rng=rng(),
                                device="cpu"),
                       jm.infer(Xte, nonideal=jspec, rng=rng()))


@pytest.mark.parametrize("name,s", [("iris", 16), ("cancer", 32)])
def test_sa_offsets_and_noise_equal_both_oracles(name, s):
    tm, jm, Xte = _models(name, s)
    kw = dict(sa_sigma=0.03, sigma_in=0.04)
    got = tm.infer(Xte, backend="torch", device="cpu",
                   nonideal=NonIdealSpec(**kw), rng=np.random.default_rng(7))
    assert_same_result(got, jm.infer(Xte, nonideal=JaxSpec(**kw),
                                     rng=np.random.default_rng(7)))
    assert_same_result(got, tm.infer(Xte, nonideal=NonIdealSpec(**kw),
                                     rng=np.random.default_rng(7), device="cpu"))


@pytest.mark.parametrize("name,s", [("iris", 16), ("cancer", 32)])
def test_faulted_layout_equals_both_oracles(name, s):
    """On one stuck-fault layout whose padding columns stay don't-care (as a
    served chip's do), the kernel path equals the numpy oracles.  DT2CAM.infer
    itself leaves faults in the padding columns, which the oracle masks and
    the match kernels count, in both packages alike (ROADMAP.md Queue C)."""
    from repro.core import simulate as j_simulate
    from repro_torch.core import CELL_X, apply_saf, encode_inputs, simulate
    from repro_torch.kernels import tcam_infer

    tm, _, Xte = _models(name, s)
    ideal = tm.compiled.layout
    cells = apply_saf(ideal.cells, 0.02, 0.01, np.random.default_rng(7))
    cells[:, 1 + ideal.width:] = CELL_X
    assert (cells != ideal.cells).any()
    lay = dataclasses.replace(ideal, cells=cells)
    xbits = encode_inputs(tm.compiled.lut, Xte)
    got = tcam_infer(lay, xbits, engine="mxu", device="cpu")
    assert_same_result(got, simulate(lay, xbits))
    assert_same_result(got, j_simulate(lay, xbits))


def test_sa_variability_alone_keeps_packed_legal():
    tm, jm, Xte = _models("cancer", 32)
    got = tm.infer(Xte, backend="torch", engine="packed", device="cpu",
                   nonideal=NonIdealSpec(sa_sigma=0.05),
                   rng=np.random.default_rng(3))
    want = jm.infer(Xte, backend="jax", engine="packed",
                    nonideal=JaxSpec(sa_sigma=0.05), rng=np.random.default_rng(3))
    assert_same_result(got, want)


def test_selective_precharge_off_matches_jax():
    tm, jm, Xte = _models("iris", 16)
    got = tm.infer(Xte, backend="torch", selective_precharge=False,
                   device="cpu")
    assert_same_result(got, jm.infer(Xte, backend="jax",
                                     selective_precharge=False))
    rows = tm.compiled.layout.cells.shape[0] * tm.compiled.layout.n_cwd
    assert (got.active_evals == rows).all()


def test_feature_mismatch_and_illegal_engine_raise():
    tm, _, Xte = _models("iris", 16)
    with pytest.raises(FeatureMismatch):
        tm.infer(Xte[:, :3], backend="torch", device="cpu")
    with pytest.raises(ValueError):
        tm.infer(Xte, backend="torch", engine="packed", device="cpu")
    with pytest.raises(ValueError):
        tm.infer(Xte, backend="jax", device="cpu")
    spec = NonIdealSpec(p_sa1=0.05)
    tm32, _, Xte32 = _models("cancer", 32)
    with pytest.raises(ValueError):
        tm32.infer(Xte32, backend="torch", engine="packed", device="cpu",
                   nonideal=spec, rng=np.random.default_rng(0))
