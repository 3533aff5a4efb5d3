"""The port's checkpoint manager against the JAX package's on-disk layout.

A JAX ``TrainState`` (reduced olmo, bf16 AdamW moments, an EF residual)
saved by the JAX package restores in the port leaf for leaf, bit for bit,
bf16 leaves included; the port saving the same state writes the same
directory byte for byte (every ``.npy``, the manifest); a checkpoint the
port writes restores in the JAX package leaf for leaf where its leaves
are f32 and int32.  The JAX package's own ``restore`` cannot turn a bf16
leaf (a ``'<V2'`` ``.npy``) into a JAX array, whoever wrote it: the last
test pins that gap of the reference (ROADMAP Queue C).  Then the
manager's failure semantics: ``.tmp`` and corrupt dirs skipped, ``keep``
retention, the CRC check, and nothing to restore.  All comparisons exact.
"""
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro import train as JT
from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import get_reduced as jax_get_reduced
from repro_torch.checkpoint import CheckpointManager, restore_resharded
from repro_torch.configs import get_reduced
from repro_torch.convert import (train_state_from_arrays,
                                 train_state_to_arrays)
from repro_torch.train import TrainState, init_train_state
from repro_torch.pytree import tree_leaves


def _jax_state(moments="bfloat16", compress=True):
    cfg = jax_get_reduced("olmo_1b")
    opt = JO.AdamWConfig(mu_dtype=moments, nu_dtype=moments)
    st = JT.init_train_state(cfg, jax.random.PRNGKey(0), compress=compress,
                             opt_cfg=opt)
    # nonzero moments, residual and step, so every leaf carries data
    rng = np.random.default_rng(0)
    fill = lambda a: jax.numpy.asarray(
        rng.standard_normal(a.shape).astype(np.float32)).astype(a.dtype)
    return JT.TrainState(
        params=st.params,
        opt=JO.OptState(mu=jax.tree.map(fill, st.opt.mu),
                        nu=jax.tree.map(fill, st.opt.nu),
                        step=jax.numpy.int32(7)),
        ef=None if st.ef is None else jax.tree.map(fill, st.ef))


def _port_like(compress=True, moments="bfloat16"):
    from repro_torch.optim import AdamWConfig
    return init_train_state(
        get_reduced("olmo_1b"), 1, compress=compress, device="cpu",
        opt_cfg=AdamWConfig(mu_dtype=moments, nu_dtype=moments))


def _files(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).iterdir())}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    js = _jax_state()
    JaxManager(str(tmp_path)).save(7, js)
    got, step = CheckpointManager(str(tmp_path)).restore(_port_like())
    assert step == 7 and isinstance(got, TrainState)
    want = jax.tree.leaves(js)
    assert len(tree_leaves(got)) == len(want)
    n_bf16 = 0
    for t, w in zip(tree_leaves(got), want):
        w = np.asarray(w)
        assert tuple(t.shape) == w.shape
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
        if t.dtype == torch.bfloat16:
            n_bf16 += 1
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), w)
    assert n_bf16 == 2 * len(jax.tree.leaves(js.params))
    # the restored state as host arrays: bf16 leaves are their int16 words
    back = jax.tree.leaves(tuple(train_state_to_arrays(got)))
    for a, w in zip(back, want):
        w = np.asarray(w)
        if w.dtype == jax.numpy.bfloat16:
            assert a.dtype == np.int16
            a = a.view(w.dtype)
        np.testing.assert_array_equal(a, w)


def test_port_writes_the_jax_layout_byte_for_byte(tmp_path):
    js = _jax_state()
    JaxManager(str(tmp_path / "jax")).save(7, js)
    ts = train_state_from_arrays(jax.tree.map(np.asarray, js), device="cpu")
    CheckpointManager(str(tmp_path / "port")).save(7, ts)
    want = _files(tmp_path / "jax" / "step_000000007")
    got = _files(tmp_path / "port" / "step_000000007")
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    manifest = json.loads(want["manifest.json"])
    assert {m["dtype"] for m in manifest["leaves"]} == {
        "float32", "bfloat16", "int32"}


def test_port_checkpoint_restores_in_jax(tmp_path):
    js = _jax_state(moments="float32")
    ts = train_state_from_arrays(jax.tree.map(np.asarray, js), device="cpu")
    CheckpointManager(str(tmp_path)).save(3, ts)
    got, step = JaxManager(str(tmp_path)).restore(js)
    assert step == 3
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # and back: the port's arrays of its own state equal the JAX leaves
    # (bf16 leaves come back as their int16 words)
    back = train_state_to_arrays(ts)
    for g, w in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(js)):
        w = np.asarray(w)
        if w.dtype == jax.numpy.bfloat16:
            assert g.dtype == np.int16
            g = g.view(w.dtype)
        np.testing.assert_array_equal(g, w)


def test_bf16_leaves_fail_in_the_reference_restore_from_either_writer(
        tmp_path):
    js = _jax_state()
    ts = train_state_from_arrays(jax.tree.map(np.asarray, js), device="cpu")
    JaxManager(str(tmp_path / "jax")).save(1, js)
    CheckpointManager(str(tmp_path / "port")).save(1, ts)
    for d in ("jax", "port"):
        with pytest.raises(TypeError, match="V2"):
            JaxManager(str(tmp_path / d)).restore(js)


def test_restore_bf16_round_trip_and_crc(tmp_path):
    ts = _port_like()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, ts)
    got, step = mgr.restore(ts, verify_crc=True)
    assert step == 2
    for a, b in zip(tree_leaves(got), tree_leaves(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # same shape, other bytes: restorable, but the CRC check catches it
    meta = json.loads((tmp_path / "step_000000002" / "manifest.json")
                      .read_text())["leaves"][0]
    path = tmp_path / "step_000000002" / meta["path"]
    arr = np.load(path)
    np.save(path, arr + 1)
    assert mgr.latest_step() == 2
    with pytest.raises(IOError, match="crc"):
        mgr.restore(ts, verify_crc=True)


def test_tmp_and_corrupt_dirs_are_skipped(tmp_path):
    ts = _port_like(compress=False, moments="float32")
    mgr = CheckpointManager(str(tmp_path), keep=5)
    assert mgr.restore(ts) is None and mgr.latest_step() is None
    mgr.save(1, ts)
    mgr.save(2, ts)
    # step 2's first leaf loses its shape: corrupt, so step 1 is latest
    d = tmp_path / "step_000000002"
    np.save(d / "arr_00000.npy", np.zeros(3, np.float32))
    # a crash mid-save leaves a .tmp dir, which is never a checkpoint
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert mgr.latest_step() == 1
    _, step = restore_resharded(mgr, ts)
    assert step == 1
    (tmp_path / "step_000000001" / "manifest.json").write_text("{")
    assert mgr.latest_step() is None
    # the next save removes the .tmp dir
    mgr.save(3, ts)
    assert not (tmp_path / "step_000000009.tmp").exists()
    assert mgr.latest_step() == 3


def test_keep_retains_the_newest(tmp_path):
    ts = _port_like(compress=False, moments="float32")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (5, 10, 15, 20):
        mgr.save(s, ts)
    assert sorted(os.listdir(tmp_path)) == ["step_000000015",
                                            "step_000000020"]
    state, step = mgr.restore(ts, step=15)
    assert step == 15 and torch.equal(state.params["embed"],
                                      ts.params["embed"])
