"""The data-parallel train step over a ``DeviceMesh``, on two and on one
``gloo`` ranks on the CPU, against the one-process step.

Each rank is a spawned process (``torch_ranks.spawn``, one torch thread,
a deadline of its own); the one-process references run here, in one
thread too.  Reduced olmo-1b under ``dp_only`` rules (its
``TRAIN_SETTINGS``), reduced qwen3-moe under the default rules, f32 state,
AdamW as ``test_torch_train.py`` (lr 1e-3, warm-up 2 of 10),
``TokenPipeline(cfg, B, 32, seed=0)``'s global batch on every rank.

What is held, and how closely (fixed before the first run):

- 2 ranks x accum 1 against one process with accum 2, for both archs: the
  loss bit for bit (both sum the same two microbatch losses); ``grad_norm``
  within 1e-6 relative; every param, ``mu`` and ``nu`` leaf within 1e-6 of
  the leaf's largest magnitude.  A global norm is the sum over every
  rank's shard of every leaf; a per-shard norm is off by about sqrt(2).
  (In the runs made so far every leaf and the norm came out bit for bit:
  ``DTensor`` reduces each leaf's sum of squares over the ranks before the
  leaves are added, in the one-process order.)
- 2 ranks x accum 2 against accum 4 (the microbatch gradients summed in
  another order): the loss within 1e-6 relative, the leaves as above.
- one compressed step against the one-process compressed step: the EF
  residual bit for bit, which needs each leaf's int8 scale to be the
  global ``abs().max()`` (a per-shard scale moves every residual of the
  other shard); and ``quantize_int8`` of a sharded tensor gives the whole
  tensor's scale exactly.
- a checkpoint saved on 2 ranks is byte for byte the one one process saves
  from the same (gathered) state; restored 1 -> 2 and 2 -> 1 ranks, the
  leaves are the saved ones bit for bit and one step after it holds as
  above (on the mesh of one, bit for bit).
- a mesh of one equals ``rules=None`` bit for bit over two steps, and one
  compressed step.
- a mesh whose "model" axis is 2 makes ``build_train_step`` raise
  ``ValueError``; ``shard`` redistributes a ``DTensor`` to its spec.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, restore_resharded
from repro_torch.configs import get_reduced
from repro_torch.data import TokenPipeline
from repro_torch.optim import AdamWConfig
from repro_torch.pytree import tree_leaves, tree_unflatten
from repro_torch.train import build_train_step, init_train_state
from torch_ranks import gathered, spawn

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
SEQ = 32
LEAF_TOL = 1e-6
NORM_RTOL = 1e-6
MOE = "qwen3_moe_235b_a22b"


def _cfg(arch):
    return get_reduced(arch), AdamWConfig(**OPT)


def _batch(cfg, b, step=0):
    return TokenPipeline(cfg, b, SEQ, seed=0).batch_at(step)


def _rules(mesh, arch):
    from repro_torch.sharding import make_rules
    return make_rules(mesh, dp_only=arch == "olmo_1b")


def _run(arch, rules, batch, *, accum=1, compress=False, steps=1, state=None):
    cfg, opt = _cfg(arch)
    if state is None:
        state = init_train_state(cfg, 0, opt_cfg=opt, device="cpu",
                                 compress=compress, rules=rules)
    step = build_train_step(cfg, opt, rules=rules, accum=accum,
                            compress=compress)
    for i in range(steps):
        state, m = step(state, batch if i == 0 else _batch(cfg, len(
            batch["tokens"]), i))
    return state, {k: v.clone() for k, v in m.items()}


# -- the ranks (spawned) ------------------------------------------------------
def two_ranks(rank, world, out, ckpt1):
    """Everything that needs 2 ranks; rank 0 returns what it saw."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import mesh_for_devices
    from repro_torch.optim import quantize_int8
    from repro_torch.sharding import make_rules, shard, use_rules

    mesh = mesh_for_devices(2, device="cpu")
    res = {}
    for arch in ("olmo_1b", MOE):
        cfg, _ = _cfg(arch)
        st, m = _run(arch, _rules(mesh, arch), _batch(cfg, 4))
        res[arch] = (gathered(st), m)
        if arch == "olmo_1b":
            emb = st.params["embed"]
            res["embed_local"] = tuple(emb.to_local().shape)
            CheckpointManager(os.path.join(out, "ckpt2")).save(1, st)
    cfg, _ = _cfg("olmo_1b")
    st, m = _run("olmo_1b", _rules(mesh, "olmo_1b"), _batch(cfg, 8), accum=2)
    res["accum"] = (gathered(st), m)
    st, m = _run("olmo_1b", _rules(mesh, "olmo_1b"), _batch(cfg, 4),
                 compress=True)
    res["compress"] = (gathered(st), m)
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(3))
    x[5, 2] = 9.0                      # the largest |x| lies on rank 1
    rules = _rules(mesh, "olmo_1b")
    d = DTensor.from_local(x.chunk(2)[rank], mesh, rules.placements(
        ("act_batch", None), x.shape), run_check=False)
    with implicit_replication():
        res["scale"] = quantize_int8(d)[1].full_tensor()
    # 1 -> 2: a one-process checkpoint onto this mesh, then one step
    like = init_train_state(cfg, 1, opt_cfg=_cfg("olmo_1b")[1],
                            device="cpu", rules=rules)
    restored, at = restore_resharded(CheckpointManager(ckpt1), like)
    res["restored"] = (at, gathered(restored),
                       [p.placements for p in tree_leaves(restored.params)]
                       == [p.placements for p in tree_leaves(like.params)])
    st, m = _run("olmo_1b", rules, _batch(cfg, 4, 1), state=restored)
    res["after_restore"] = (gathered(st), m)
    # shard() redistributes a DTensor; plain tensors pass through
    with use_rules(rules):
        full = shard(d, None, None)
        res["shard"] = (full.placements, torch.equal(full.full_tensor(), x),
                        shard(x, "act_batch") is x)
    # a "model" axis of 2
    wide = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    try:
        build_train_step(cfg, _cfg("olmo_1b")[1], rules=make_rules(wide))
        res["model_axis"] = None
    except ValueError as e:
        res["model_axis"] = str(e)
    return res if rank == 0 else None


def one_rank(rank, world, out, ckpt2):
    """A mesh of one against rules=None, and the 2 -> 1 restore."""
    from repro_torch.launch import mesh_for_devices
    from repro_torch.sharding import make_rules

    rules = make_rules(mesh_for_devices(1, device="cpu"), dp_only=True)
    cfg, opt = _cfg("olmo_1b")
    res = {}
    for compress, steps in ((False, 2), (True, 1)):
        got = _run("olmo_1b", rules, _batch(cfg, 4), compress=compress,
                   steps=steps)
        want = _run("olmo_1b", None, _batch(cfg, 4), compress=compress,
                    steps=steps)
        res[compress] = (gathered(got[0]), got[1], tree_leaves(want[0]),
                         want[1])
    like = init_train_state(cfg, 1, opt_cfg=opt, device="cpu", rules=rules)
    restored, at = restore_resharded(CheckpointManager(ckpt2), like)
    st, m = _run("olmo_1b", rules, _batch(cfg, 4, 1), state=restored)
    res["restored"] = (at, gathered(restored), gathered(st), m)
    return res


# -- the checks ----------------------------------------------------------------
@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """The one-process checkpoint the ranks restore, then both spawns."""
    cfg, opt = _cfg("olmo_1b")
    ref, _ = _run("olmo_1b", None, _batch(cfg, 4), accum=2)
    ckpt1 = tmp_path_factory.mktemp("ckpt1")
    CheckpointManager(str(ckpt1)).save(1, ref)
    two_dir = tmp_path_factory.mktemp("two")
    two = spawn(two_ranks, 2, two_dir, str(ckpt1))[0]
    one = spawn(one_rank, 1, tmp_path_factory.mktemp("one"),
                str(two_dir / "ckpt2"))[0]
    return {"ref": ref, "ckpt1": ckpt1, "two_dir": two_dir, "two": two,
            "one": one}


def _close(got, want, what):
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        top = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= LEAF_TOL * top, (what, err, top)


@pytest.mark.parametrize("arch", ["olmo_1b", MOE])
def test_two_ranks_equal_one_process_with_accum_2(runs, arch):
    leaves, m = runs["two"][arch]
    cfg, _ = _cfg(arch)
    want, wm = _run(arch, None, _batch(cfg, 4), accum=2)
    _close(leaves, tree_leaves(want), arch)
    assert torch.equal(m["loss"], wm["loss"])
    assert set(m) == set(wm) | {"tokens"} and int(m["tokens"]) == 4 * SEQ


@pytest.mark.parametrize("arch", ["olmo_1b", MOE])
def test_grad_norm_is_the_global_one(runs, arch):
    _, m = runs["two"][arch]
    cfg, _ = _cfg(arch)
    _, wm = _run(arch, None, _batch(cfg, 4), accum=2)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]),
                               rtol=NORM_RTOL)
    assert torch.equal(m["lr"], wm["lr"])


def test_state_rests_in_shards(runs):
    cfg, _ = _cfg("olmo_1b")
    assert runs["two"]["embed_local"] == (cfg.vocab_size, cfg.d_model // 2)


def test_two_ranks_accum_2_equal_accum_4(runs):
    leaves, m = runs["two"]["accum"]
    cfg, _ = _cfg("olmo_1b")
    want, wm = _run("olmo_1b", None, _batch(cfg, 8), accum=4)
    _close(leaves, tree_leaves(want), "accum")
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                               rtol=NORM_RTOL)


def test_compressed_step_uses_the_global_int8_scale(runs):
    from repro_torch.optim import quantize_int8
    leaves, m = runs["two"]["compress"]
    cfg, _ = _cfg("olmo_1b")
    want, wm = _run("olmo_1b", None, _batch(cfg, 4), accum=2, compress=True)
    n_ef = len(tree_leaves(want.ef))
    assert all(torch.equal(a, b) for a, b in zip(
        leaves[-n_ef:], tree_leaves(want.ef))), "EF residual"
    _close(leaves, tree_leaves(want), "compressed step")
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(3))
    x[5, 2] = 9.0
    assert torch.equal(runs["two"]["scale"], quantize_int8(x)[1])


def test_checkpoint_from_two_ranks_is_the_one_process_checkpoint(runs,
                                                                 tmp_path):
    two = runs["two_dir"] / "ckpt2"
    cfg, opt = _cfg("olmo_1b")
    like = init_train_state(cfg, 0, opt_cfg=opt, device="cpu")
    state = tree_unflatten(like, runs["two"]["olmo_1b"][0])
    CheckpointManager(str(tmp_path)).save(1, state)
    names = sorted(os.listdir(two / "step_000000001"))
    assert names == sorted(os.listdir(tmp_path / "step_000000001"))
    assert not [n for n in os.listdir(two) if n.endswith(".tmp")]
    for n in names:
        assert (two / "step_000000001" / n).read_bytes() == (
            tmp_path / "step_000000001" / n).read_bytes(), n


def test_restore_one_process_checkpoint_onto_two_ranks(runs):
    at, leaves, same_placements = runs["two"]["restored"]
    assert at == 1 and same_placements
    assert all(torch.equal(a, b) for a, b in zip(
        leaves, tree_leaves(runs["ref"])))
    got, m = runs["two"]["after_restore"]
    cfg, _ = _cfg("olmo_1b")
    want, wm = _run("olmo_1b", None, _batch(cfg, 4, 1), accum=2,
                    state=runs["ref"])
    _close(got, tree_leaves(want), "step after the restore")
    assert torch.equal(m["loss"], wm["loss"])


def test_restore_two_rank_checkpoint_onto_a_mesh_of_one(runs):
    at, leaves, got, m = runs["one"]["restored"]
    cfg, opt = _cfg("olmo_1b")
    like = init_train_state(cfg, 1, opt_cfg=opt, device="cpu")
    state, step = CheckpointManager(str(runs["two_dir"] / "ckpt2")).restore(
        like)
    assert at == step == 1
    assert all(torch.equal(a, b) for a, b in zip(leaves, tree_leaves(state)))
    want, wm = _run("olmo_1b", None, _batch(cfg, 4, 1), state=state)
    assert all(torch.equal(a, b) for a, b in zip(got, tree_leaves(want)))
    assert all(torch.equal(m[k], wm[k]) for k in wm)


@pytest.mark.parametrize("compress", [False, True])
def test_mesh_of_one_equals_the_unsharded_step(runs, compress):
    got, m, want, wm = runs["one"][compress]
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(m) == set(wm) and all(torch.equal(m[k], wm[k]) for k in wm)


def test_model_axis_above_one_raises(runs):
    assert "'model' axis larger than 1" in runs["two"]["model_axis"]


def test_shard_redistributes_a_dtensor(runs):
    from torch.distributed.tensor import Replicate
    placements, same, passthrough = runs["two"]["shard"]
    assert placements == (Replicate(), Replicate()) and same and passthrough
