"""The sharded train steps over a ("pod", "data", "model") ``DeviceMesh``
on ``gloo`` ranks on the CPU, against the port's unsharded step and the
JAX package's unsharded ``build_train_step(cfg, None, opt)`` with the same
``accum``: the reference's step, whatever the mesh.

The state, batch, AdamW and f32 compute are ``test_torch_tp_train.py``'s.
The meshes: (2, 1, 1) (one spawn of 2 ranks), (2, 2, 1), (2, 1, 2) and
(1, 2, 2) (one spawn of 4 ranks).  The cases on each:

- the tensor-parallel step (``make_rules(mesh)``: the batch over ("pod",
  "data"), the FSDP ``embed`` dim over ("pod", "data") gathered at use)
  for reduced olmo-1b (dense) and qwen3-moe, one microbatch;
- qwen3-moe with ``test_torch_tp_train_meshes.py``'s ``SPAN``: one token
  group a microbatch, capacity factor 0.5 (tokens are dropped), labels of
  -1 on parts of two rows, 2 microbatches of 2 rows (on a mesh of 4 batch
  shards the 2 rows do not split, and every batch shard runs them whole);
- the ``dp_only`` step for olmo-1b: the batch over ("data", "model"),
  every pod running the same rows, "pod" carrying only FSDP;
- on 4 ranks, a checkpoint saved on the 2-axis mesh (2, 2) after a step,
  restored onto (2, 1, 2), saved there and restored onto (2, 2).

What is held (fixed before the first run):

- the tensor-parallel steps against the port's unsharded step at
  ``test_torch_tp_train.py``'s tolerances (the loss within 1e-6 relative,
  each gradient leaf within 1e-5 of its largest |g|, ``grad_norm``
  within 1e-5, ``lr`` equal, ``mu``/``nu`` and the params as its
  ``check_step``), and against the JAX package at its JAX tolerances
  (the loss within 1e-5, each gradient leaf within 1e-4 of its largest
  |g|, the state as ``check_step`` at 1e-4); every rank's state after the
  step laid out as ``input_specs`` gives;
- the ``dp_only`` step: the loss within 1e-6 relative and the state after
  the step as ``check_step`` at 1e-5 against the port's unsharded step,
  the state at 1e-4 against the JAX package's; its state laid out too;
- the checkpoint: the restored leaves bit for bit the saved ones, with
  the placements of the new mesh's rules, both ways; a step from the
  restored state on (2, 1, 2) bit for bit the step from the saved state
  sharded there directly.
"""
import concurrent.futures

import pytest
import torch

from test_torch_tp_train import (GRAD_TOL, JAX_GRAD_TOL, JAX_LOSS_RTOL,
                                 LOSS_RTOL, NORM_RTOL, batch_of, check_step,
                                 close_leaves, compute, jax_run, leaves,
                                 old_params, opt_cfg, run, state_of)
from test_torch_tp_train_meshes import SPAN
from torch_ranks import gathered, spawn

AXES = ("pod", "data", "model")
MESHES = ((2, 1, 1), (2, 2, 1), (2, 1, 2), (1, 2, 2))
DENSE, MOE = "olmo_1b", "qwen3_moe_235b_a22b"
SPAN_ACCUM = 2
CKPT_ARCH = "olmo_1b"


def _rules(shape, **kw):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import make_rules
    names = AXES[-len(shape):]
    return make_rules(init_device_mesh("cpu", shape, mesh_dim_names=names),
                      **kw)


def dp_run(arrays, arch, rules=None) -> dict:
    """One ``dp_only`` step (f32 compute): the state after it (whole
    leaves) and its metrics."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import param_logical_axes
    from repro_torch.train import build_train_step
    from repro_torch.train.step import _check_shards
    cfg = get_reduced(arch)
    state = state_of(arrays, cfg, rules)
    batch = {k: torch.as_tensor(v) for k, v in batch_of(cfg).items()}
    with compute():
        new, m = build_train_step(cfg, opt_cfg(), rules=rules)(state, batch)
    for tree in (new.params, new.opt.mu, new.opt.nu):
        _check_shards(tree, param_logical_axes(cfg), rules, "state")
    return {"leaves": gathered(new),
            "metrics": {k: v.clone() for k, v in m.items()}}


def _mesh_cases(arrays, shape) -> dict:
    rules = _rules(shape)
    return {"dense": run(arrays[DENSE], DENSE, rules),
            "moe": run(arrays[MOE], MOE, rules),
            "span": run(arrays[MOE], MOE, rules, SPAN_ACCUM, **SPAN),
            "dp_only": dp_run(arrays[DENSE], DENSE,
                              _rules(shape, dp_only=True))}


def _checkpoint(arrays, out) -> dict:
    """(2, 2) -> (2, 1, 2) -> (2, 2) through the checkpoint manager."""
    import os

    from repro_torch.checkpoint import CheckpointManager, restore_resharded
    from repro_torch.configs import get_reduced
    from repro_torch.pytree import tree_leaves
    from repro_torch.train import build_train_step, init_train_state
    cfg = get_reduced(CKPT_ARCH)
    batch = {k: torch.as_tensor(v) for k, v in batch_of(cfg).items()}
    r22, r212 = _rules((2, 2)), _rules((2, 1, 2))
    with compute():
        st, _ = build_train_step(cfg, opt_cfg(), rules=r22)(
            state_of(arrays[CKPT_ARCH], cfg, r22), batch)
    CheckpointManager(os.path.join(out, "c22")).save(1, st)
    saved = gathered(st)

    def placements(state):
        return [t.placements for t in tree_leaves(
            (state.params, state.opt.mu, state.opt.nu))]

    res = {}
    like = init_train_state(cfg, 1, opt_cfg=opt_cfg(), device="cpu",
                            rules=r212)
    st212, at = restore_resharded(CheckpointManager(os.path.join(out, "c22")),
                                  like)
    res["212"] = (at, all(torch.equal(a, b) for a, b in zip(
        gathered(st212), saved)), placements(st212) == placements(like))
    CheckpointManager(os.path.join(out, "c212")).save(1, st212)
    like = init_train_state(cfg, 1, opt_cfg=opt_cfg(), device="cpu",
                            rules=r22)
    back, at = restore_resharded(CheckpointManager(os.path.join(out, "c212")),
                                 like)
    res["22"] = (at, all(torch.equal(a, b) for a, b in zip(
        gathered(back), saved)), placements(back) == placements(like))
    # a step from the restored state, and from the saved state sharded
    # onto (2, 1, 2) directly
    from repro_torch.pytree import tree_unflatten
    from repro_torch.train import shard_state
    whole = tree_unflatten(state_of(arrays[CKPT_ARCH], cfg), saved)
    step = build_train_step(cfg, opt_cfg(), rules=r212)
    with compute():
        a, ma = step(st212, batch)
        b, mb = step(shard_state(whole, cfg, r212), batch)
    res["step"] = (all(torch.equal(x, y) for x, y in zip(gathered(a),
                                                          gathered(b)))
                   and all(torch.equal(ma[k], mb[k]) for k in mb))
    return res


def pod_train_ranks(rank, world, out, shapes, arrays):
    """The cases on each of ``shapes``; on 4 ranks also the checkpoint.
    Rank 0 returns what it saw."""
    res = {shape: _mesh_cases(arrays, shape) for shape in shapes}
    if world == 4:
        res["checkpoint"] = _checkpoint(arrays, out)
    return res if rank == 0 else None


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    arrays = {arch: leaves(arch) for arch in (DENSE, MOE)}

    def spawns():
        got = spawn(pod_train_ranks, 2, tmp_path_factory.mktemp("two"),
                    MESHES[:1], arrays)[0]
        got.update(spawn(pod_train_ranks, 4, tmp_path_factory.mktemp("four"),
                         MESHES[1:], arrays)[0])
        return got

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawns)
        port = {"dense": run(arrays[DENSE], DENSE),
                "moe": run(arrays[MOE], MOE),
                "span": run(arrays[MOE], MOE, None, SPAN_ACCUM, **SPAN)}
        jx = {"dense": jax_run(arrays[DENSE], DENSE, 1),
              "moe": jax_run(arrays[MOE], MOE, 1),
              "span": jax_run(arrays[MOE], MOE, SPAN_ACCUM,
                              masked=SPAN["masked"], edit=SPAN["edit"])}
        return {"ranks": ranks.result(), "port": port, "jax": jx,
                "arrays": arrays}


def _mesh_id(shape):
    return "x".join(map(str, shape))


CASES = ("dense", "moe", "span")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
def test_pod_step_equals_the_unsharded_port(runs, shape, case):
    got, want = runs["ranks"][shape][case], runs["port"][case]
    arch = DENSE if case == "dense" else MOE
    assert abs(float(got["loss"]) - float(want["loss"])) <= (
        LOSS_RTOL * abs(float(want["loss"])))
    close_leaves(got["grads"], want["grads"], GRAD_TOL, "grads")
    gm, wm = got["metrics"], want["metrics"]
    assert set(gm) == set(wm)
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= (
        NORM_RTOL * float(wm["grad_norm"]))
    assert torch.equal(gm["lr"], wm["lr"])
    if "tokens" in wm:
        assert int(gm["tokens"]) == int(wm["tokens"])
    check_step(got["leaves"], want["leaves"],
               old_params(runs["arrays"][arch]), float(wm["lr"]), GRAD_TOL,
               "port")
    assert got["layout_ok"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
def test_pod_step_equals_jax(runs, shape, case):
    got, want = runs["ranks"][shape][case], runs["jax"][case]
    arch = DENSE if case == "dense" else MOE
    assert abs(float(got["loss"]) - want["loss"]) <= (
        JAX_LOSS_RTOL * abs(want["loss"]))
    close_leaves(got["grads"], want["grads"], JAX_GRAD_TOL, "grads")
    assert abs(float(got["metrics"]["grad_norm"])
               - want["metrics"]["grad_norm"]) <= (
        JAX_LOSS_RTOL * want["metrics"]["grad_norm"])
    check_step(got["leaves"], want["leaves"],
               old_params(runs["arrays"][arch]), want["metrics"]["lr"],
               JAX_GRAD_TOL, "jax")


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
def test_pod_dp_only_step_equals_the_unsharded_step_and_jax(runs, shape):
    got = runs["ranks"][shape]["dp_only"]
    want, jx = runs["port"]["dense"], runs["jax"]["dense"]
    old = old_params(runs["arrays"][DENSE])
    gm, wm = got["metrics"], want["metrics"]
    assert set(gm) == set(wm)
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= (
        LOSS_RTOL * abs(float(wm["loss"])))
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= (
        NORM_RTOL * float(wm["grad_norm"]))
    assert int(gm["tokens"]) == int(wm["tokens"])
    check_step(got["leaves"], want["leaves"], old, float(wm["lr"]),
               GRAD_TOL, "port")
    assert abs(float(gm["loss"]) - jx["loss"]) <= (
        JAX_LOSS_RTOL * abs(jx["loss"]))
    check_step(got["leaves"], jx["leaves"], old, jx["metrics"]["lr"],
               JAX_GRAD_TOL, "jax")


def test_pod_checkpoint_moves_between_2_and_3_axis_meshes(runs):
    res = runs["ranks"]["checkpoint"]
    for mesh in ("212", "22"):
        at, same, placements = res[mesh]
        assert at == 1 and same and placements, mesh
    assert res["step"]

