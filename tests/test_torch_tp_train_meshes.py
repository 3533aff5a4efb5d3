"""The tensor-parallel train step, continued (``test_torch_tp_train.py``
holds meshes (1, 2) and (2, 2) for every configuration and the
tolerances' reasons): the collectives' backwards, the mesh of one, meshes
(1, 4) and (1, 3), accumulation, bf16 state, compression and checkpoints,
on ``gloo`` ranks on the CPU against the port's unsharded step.

The state, batch and AdamW are ``test_torch_tp_train.py``'s.  What is
held, and how closely (fixed before the first run):

- each pair of ``sharding.collectives`` on 2 ranks, its gradient against
  the same function's unsharded gradient within 1e-6 relative: ``sum``
  (identity backward) and ``enter`` (sum backward) over "model", the
  activation gather over "model" (own slice backward), the param gather
  over "data" at use (reduce-scatter backward); ``max`` gives no gradient.
  The backward that PyTorch registers for the functional collectives is
  recorded beside them on the same inputs: for the all-reduce and the
  all-gather it is the unsharded gradient times the number of ranks;
- the mesh of one, every configuration in bf16 compute as trained: the
  loss, every gradient leaf, the metrics and every leaf after the step
  equal to the unsharded step's bit for bit;
- meshes (1, 4) and (1, 3) for paligemma (one kv head), phi3 (two kv
  heads in the reduced config: 4 and 3 divide neither), qwen3-moe, jamba,
  rwkv6 and whisper: as ``test_torch_tp_train.py`` holds (1, 2) against
  the unsharded port (f32);
- ``accum=2`` on (1, 2) (qwen3-moe, whose token groups are each
  microbatch's) against the unsharded ``accum=2``: as above;
- a batch that does not split over "data", where every data rank runs
  all the rows: 1 row of olmo-1b on (2, 1) and 2 rows of qwen3-moe on
  (4, 1), against the unsharded step on those rows, as above (a sum over
  "data" of the gathered weights' gradients would count each D times);
- the reference's microbatches on (2, 1), (2, 2) and the 3-axis mesh
  (2, 1, 2): qwen3-moe with one token group and capacity factor 0.5
  (tokens are dropped), labels of -1 on parts of two rows, 2
  microbatches, against the unsharded port with the same 2 as above and
  against the JAX package's step with 2 at ``test_torch_tp_train.py``'s
  JAX tolerances: one group a microbatch spanning the batch shards, the
  loss the whole microbatch's mean.  Each batch shard's rows taken as
  their own microbatches and groups (the unsharded step with 4) lie
  beyond the port tolerance;
- jamba with bf16 ``accum_dtype`` and bf16 moments (its
  ``TRAIN_SETTINGS``) in bf16 compute on (2, 2), 2 microbatches, against
  the unsharded step with 2: each gradient leaf's distance from
  the unsharded bf16 gradient, read as ``test_torch_train.py`` reads its
  bands (the largest difference over the largest |g|, the norm of the
  difference over the norm), at most twice the unsharded bf16 gradient's
  own distance from its f32 gradient plus 2**-8; the loss within 1e-2
  relative and the bf16 moments as bf16 (the dtype kept);
- a compressed step on (1, 2) (paligemma, f32): every leaf's dequantized
  gradient (read from ``mu``) an integer multiple of one scale, the whole
  leaf's (a scale per shard would leave the other shard's values off that
  grid), which equals the unsharded compressed step's scale within 1e-5
  relative, and the EF residual plus the dequantized gradient equal to
  the sharded gradient within 1e-6 of its largest |g|;
- a checkpoint saved on (1, 2) after one step (phi3, f32), restored onto
  (2, 1) and onto (1, 1): the leaves bit for bit the saved ones, the
  placements the new mesh's rules'; the next step on (1, 1) bit for bit
  the unsharded step's from the saved state, and on (2, 1) held against
  the same unsharded step as above, but for the params:
  past the first step AdamW's update no longer reduces to the sign of the
  gradient, so each param is held within ``lr`` times the update's first
  order change under a gradient error ``dg`` (the gradient tolerance of
  the leaf's largest |g|), ``(1 - b1) dg / c1 / (s + eps) + |mhat| ds /
  (s + eps)**2`` with ``s = sqrt(vhat)`` and ``ds`` the change of ``s``
  under the second moment's change ``(1 - b2)(2|g| dg + dg**2) / c2``,
  plus 1e-4 of the leaf's largest update and 1e-6 of the param;
- the dry run's count of the tensor-parallel step's collectives
  (``launch.dryrun.shards_collectives``, on fake tensors at rank 0's
  shapes over a device-free mesh; less the squared norm's 4 bytes, which
  ``DTensor`` reduces) equals, byte for byte by type, what the
  collectives of ``sharded_grads`` move on the ranks (each ``Shards``
  collective recorded as it runs, the all-reduce of the gradients
  replicated over "data" included) on (1, 2) and (2, 1), for
  paligemma at 3 layers (the count runs 1 and 2 and extrapolates) and
  qwen3-moe with 2 microbatches.
"""
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from test_torch_tp_train import (ARCHS, GRAD_TOL, JAX_GRAD_TOL,
                                 JAX_LOSS_RTOL, LOSS_RTOL, NORM_RTOL,
                                 batch_of, check_step, close_leaves, compute,
                                 jax_run, leaves, old_params, opt_cfg, run,
                                 state_of)
from torch_ranks import gathered, spawn

NARROW = ("paligemma_3b", "phi3_medium_14b", "qwen3_moe_235b_a22b",
          "jamba_v01_52b", "rwkv6_1p6b", "whisper_small")
PAIR_RTOL = 1e-6
CKPT_ARCH = "phi3_medium_14b"
COMPRESS_ARCH = "paligemma_3b"
ACCUM_ARCH = "qwen3_moe_235b_a22b"
BF16_ARCH = "jamba_v01_52b"
# (mesh, arch, rows): a batch that does not split over "data"
FEW_ROWS = (((2, 1), "olmo_1b", 1), ((4, 1), "qwen3_moe_235b_a22b", 2))
# one token group a microbatch, dropped tokens, uneven label counts
SPAN = dict(edit=dict(moe_groups=1, capacity_factor=0.5), masked=True)
SPAN_MESHES = ((2, 1), (2, 2), (2, 1, 2))
SPAN_ACCUM = 2
BF16_FLOOR = 2.0 ** -8
BF16_LOSS_RTOL = 1e-2
SCALE_RTOL = 1e-5
COUNT_LAYERS = {"paligemma_3b": 3, "qwen3_moe_235b_a22b": 2}
COUNT_ACCUM = 2


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    names = ("pod", "data", "model")[-len(shape):]
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _rules(shape):
    from repro_torch.sharding import make_rules
    return make_rules(_mesh(shape))


# -- the collectives' backwards ----------------------------------------------------
def pair_inputs():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(2, 5, 3, generator=g),    # a part per rank
            "x": torch.randn(5, 3, generator=g),       # replicated
            "c": torch.randn(10, 3, generator=g),
            "w": torch.randn(4, 3, generator=g),       # rows over "data"
            "rows": torch.randn(2, 6, 3, generator=g)}  # a data rank's rows


def pair_functions():
    """Each pair's function of its inputs, as one rank computes it with
    ``sh`` (a ``Shards``) and unsharded, over 2 ranks: (sharded(sh, r,
    t) -> loss and the tensors whose gradients are held, unsharded(t) ->
    the same gradients, stacked by rank where each rank holds a part)."""
    def reduce_enter(sh, r, t):
        a, x = t["a"][r].requires_grad_(), t["x"].requires_grad_()
        y = sh.sum(a * sh.enter(x), "model")
        return (y.pow(2) * t["c"][:5]).sum(), (a, x)

    def reduce_enter_whole(t):
        a, x = t["a"].requires_grad_(), t["x"].requires_grad_()
        y = (a * x).sum(0)
        (y.pow(2) * t["c"][:5]).sum().backward()
        return a.grad, x.grad

    def gather(sh, r, t):
        a = t["a"][r].requires_grad_()
        z = sh.gather(a, "model", 0)
        return (z.pow(2) * t["c"]).sum(), (a,)

    def gather_whole(t):
        a = t["a"].requires_grad_()
        (a.reshape(10, 3).pow(2) * t["c"]).sum().backward()
        return (a.grad,)

    return {"reduce_enter": (reduce_enter, reduce_enter_whole),
            "gather": (gather, gather_whole)}


def funcol_grads(sh, r, t) -> dict:
    """The gradients that the functional collectives' registered backward
    gives the same functions (no ``enter``: the sum's input is ``a * x``
    with ``x`` a constant)."""
    import torch.distributed._functional_collectives as funcol
    out = {}
    group = sh.rules.group("model")
    a = t["a"][r].clone().requires_grad_()
    y = funcol.all_reduce(a * t["x"], "sum", group)
    y = y.wait() if hasattr(y, "wait") else y
    (y.pow(2) * t["c"][:5]).sum().backward()
    out["all_reduce"] = a.grad
    a = t["a"][r].clone().requires_grad_()
    z = funcol.all_gather_tensor(a, 0, group)
    z = z.wait() if hasattr(z, "wait") else z
    (z.pow(2) * t["c"]).sum().backward()
    out["all_gather"] = a.grad
    return out


def fsdp_grad(sh, r, t):
    """The param gather over "data" at use: each data rank's loss on its
    rows with the whole weight; the gradient lands as the rank's rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    w = t["w"][2 * r:2 * r + 2].clone().requires_grad_()
    leaf = DTensor.from_local(w, sh.mesh, (Shard(0), Replicate()),
                              run_check=False)
    whole = sh.at_use(leaf)
    (t["rows"][r] @ whole.T).pow(2).sum().backward()
    return w.grad


def pair_ranks(rank, world, out, arrays):
    """The pairs, then the (1, 2) cases: accumulation, compression and the
    checkpoint, restored onto (2, 1).  Rank 0 returns what it saw."""
    from repro_torch.checkpoint import CheckpointManager, restore_resharded
    from repro_torch.sharding import Shards
    res = {}
    rules = _rules((1, 2))
    sh = Shards(rules, 2)
    r = sh.rank("model")
    for name, (fn, _) in pair_functions().items():
        loss, wrt = fn(sh, r, pair_inputs())
        loss.backward()
        res[name] = [t.grad for t in wrt]
    try:
        res["funcol"] = funcol_grads(sh, r, pair_inputs())
    except RuntimeError as e:        # held by its own test, not the spawn
        res["funcol"] = {"all_reduce": str(e), "all_gather": str(e)}
    a = pair_inputs()["a"][r].requires_grad_()
    m = sh.max(a, "model")
    res["max"] = (m, m.requires_grad)
    rules21 = _rules((2, 1))
    sh21 = Shards(rules21, 2)
    res["fsdp"] = fsdp_grad(sh21, sh21.rank("data"), pair_inputs())
    res["accum"] = run(arrays[ACCUM_ARCH], ACCUM_ARCH, rules, 2)
    res["few", (2, 1)] = few_rows(arrays, (2, 1))
    res["span", (2, 1)] = run(arrays[ACCUM_ARCH], ACCUM_ARCH, rules21,
                              SPAN_ACCUM, **SPAN)
    res["compress"] = run(arrays[COMPRESS_ARCH], COMPRESS_ARCH, rules, 1,
                          compress=True)
    # the checkpoint: one step on (1, 2), saved, restored onto (2, 1)
    from repro_torch.train import build_train_step, init_train_state
    cfg = get_reduced(CKPT_ARCH)
    batch = {k: torch.as_tensor(v) for k, v in batch_of(cfg).items()}
    with compute():
        st, _ = build_train_step(cfg, opt_cfg(), rules=rules)(
            state_of(arrays[CKPT_ARCH], cfg, rules), batch)
    CheckpointManager(os.path.join(out, "ckpt12")).save(1, st)
    res["saved"] = gathered(st)
    like = init_train_state(cfg, 1, opt_cfg=opt_cfg(), device="cpu",
                            rules=rules21)
    restored, at = restore_resharded(
        CheckpointManager(os.path.join(out, "ckpt12")), like)
    res["restored21"] = (at, gathered(restored), [
        p.placements for p in _leaves_of(restored)] == [
        p.placements for p in _leaves_of(like)])
    res["after21"] = run(None, CKPT_ARCH, rules21, 1, state=restored)
    res["moved"] = {(shape, arch): moved_bytes(count_cfg(arch), rules_)
                    for shape, rules_ in (((1, 2), rules), ((2, 1), rules21))
                    for arch in COUNT_LAYERS}
    return res if rank == 0 else None


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def count_cfg(arch):
    import dataclasses
    return dataclasses.replace(get_reduced(arch),
                               n_layers=COUNT_LAYERS[arch])


def moved_bytes(cfg, rules) -> dict:
    """Bytes by collective type that the ``Shards`` collectives move in
    ``sharded_grads`` with ``COUNT_ACCUM`` microbatches, recorded as they
    run."""
    from unittest import mock

    from repro_torch.sharding import collectives as C
    from repro_torch.train import init_train_state, sharded_grads
    moved = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    ar, ag, rs = (C.Shards._all_reduce, C.Shards._all_gather,
                  C.Shards._reduce_scatter)

    def all_reduce(self, t, op, groups):
        moved["all-reduce"] += len(groups) * _nbytes(t)
        return ar(self, t, op, groups)

    def all_gather(self, t, group, n, dim):
        out = ag(self, t, group, n, dim)
        moved["all-gather"] += _nbytes(out)
        return out

    def reduce_scatter(self, t, group, n, dim):
        out = rs(self, t, group, n, dim)
        moved["reduce-scatter"] += _nbytes(out)
        return out

    state = init_train_state(cfg, 0, device="cpu", rules=rules)
    batch = {k: torch.as_tensor(v) for k, v in batch_of(cfg).items()}
    with mock.patch.object(C.Shards, "_all_reduce", all_reduce), \
            mock.patch.object(C.Shards, "_all_gather", all_gather), \
            mock.patch.object(C.Shards, "_reduce_scatter", reduce_scatter):
        sharded_grads(cfg, state.params, batch, rules, accum=COUNT_ACCUM)
    return moved


def _leaves_of(state):
    from repro_torch.pytree import tree_leaves
    return tree_leaves((state.params, state.opt.mu, state.opt.nu))


def mesh_of_one(rank, world, out, arrays, ckpt):
    """Every arch on (1, 1) in bf16 compute, and the (1, 2) checkpoint
    restored there and stepped."""
    from repro_torch.checkpoint import CheckpointManager, restore_resharded
    from repro_torch.train import init_train_state
    rules = _rules((1, 1))
    res = {arch: run(arrays[arch], arch, rules, dtype=torch.bfloat16)
           for arch in ARCHS}
    cfg = get_reduced(CKPT_ARCH)
    like = init_train_state(cfg, 1, opt_cfg=opt_cfg(), device="cpu",
                            rules=rules)
    restored, at = restore_resharded(CheckpointManager(ckpt), like)
    res["restored11"] = (at, gathered(restored))
    res["after11"] = run(None, CKPT_ARCH, rules, 1, state=restored)
    return res


def narrow_ranks(rank, world, out, shape, arrays):
    """The narrow archs on ``shape``; on 4 ranks also jamba's bf16 state
    and ``SPAN``'s case on (2, 2) and (2, 1, 2), and the rows that (4, 1)
    does not split."""
    rules = _rules(shape)
    res = {arch: run(arrays[arch], arch, rules) for arch in NARROW}
    if shape == (1, 4):
        rules22 = _rules((2, 2))
        res["bf16"] = run(arrays[BF16_ARCH], BF16_ARCH, rules22, 2,
                          **bf16_settings())
        for span in SPAN_MESHES[1:]:
            res["span", span] = run(arrays[ACCUM_ARCH], ACCUM_ARCH,
                                    _rules(span), SPAN_ACCUM, **SPAN)
        res["few", (4, 1)] = few_rows(arrays, (4, 1))
    return res if rank == 0 else None


def few_rows(arrays, shape):
    """``FEW_ROWS``' case on ``shape``."""
    _, arch, rows = next(c for c in FEW_ROWS if c[0] == shape)
    return run(arrays[arch], arch, _rules(shape), rows=rows)


def bf16_settings() -> dict:
    return dict(dtype=torch.bfloat16, accum_dtype=torch.bfloat16,
                opt=opt_cfg(mu_dtype="bfloat16", nu_dtype="bfloat16"))


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    import concurrent.futures
    arrays = {arch: leaves(arch) for arch in ARCHS}
    pair_dir = tmp_path_factory.mktemp("pairs")

    def spawns():
        out = {"pairs": spawn(pair_ranks, 2, pair_dir, arrays)[0]}
        out[(1, 1)] = spawn(mesh_of_one, 1, tmp_path_factory.mktemp("one"),
                            arrays, str(pair_dir / "ckpt12"))[0]
        for shape in ((1, 4), (1, 3)):
            out[shape] = spawn(narrow_ranks, shape[0] * shape[1],
                               tmp_path_factory.mktemp(
                                   "x".join(map(str, shape))),
                               shape, arrays)[0]
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawns)
        port = {(a, "bf16"): run(arrays[a], a, dtype=torch.bfloat16)
                for a in ARCHS}
        port.update({(a, "f32"): run(arrays[a], a) for a in NARROW})
        port["accum"] = run(arrays[ACCUM_ARCH], ACCUM_ARCH, None, 2)
        port["compress"] = run(arrays[COMPRESS_ARCH], COMPRESS_ARCH, None,
                               1, compress=True)
        port["bf16"] = run(arrays[BF16_ARCH], BF16_ARCH, None, 2,
                           **bf16_settings())
        port["bf16_f32"] = run(arrays[BF16_ARCH], BF16_ARCH, None, 2)
        for _, arch, rows in FEW_ROWS:
            port["few", arch] = run(arrays[arch], arch, rows=rows)
        # each batch shard's rows as their own microbatches: not the step
        port["span_own"] = run(arrays[ACCUM_ARCH], ACCUM_ARCH, None,
                               2 * SPAN_ACCUM, **SPAN)
        port["span"] = run(arrays[ACCUM_ARCH], ACCUM_ARCH, None, SPAN_ACCUM,
                           **SPAN)
        port["span_jax"] = jax_run(arrays[ACCUM_ARCH], ACCUM_ARCH,
                                   SPAN_ACCUM, masked=SPAN["masked"],
                                   edit=SPAN["edit"])
        got = ranks.result()
        # the references from the saved checkpoint
        from repro_torch.pytree import tree_unflatten
        like = state_of(arrays[CKPT_ARCH], get_reduced(CKPT_ARCH))
        saved = tree_unflatten(like, [t.clone() for t in
                                      got["pairs"]["saved"]])
        port["after11"] = run(None, CKPT_ARCH, None, 1, state=saved)
        return {"ranks": got, "port": port, "arrays": arrays}


# -- the checks --------------------------------------------------------------------
def _rel_close(a, b, rtol) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.abs(a - b).max() <= rtol * np.abs(b).max())


@pytest.mark.parametrize("name", ["reduce_enter", "gather"])
def test_pair_gradient_equals_the_unsharded_gradient(runs, name):
    got = runs["ranks"]["pairs"][name]
    want = pair_functions()[name][1](pair_inputs())
    # rank 0's gradients: its part of a stacked input, a replicated one
    # whole
    for g, w in zip(got, want):
        w = w[0] if w.shape != g.shape else w
        assert _rel_close(g, w, PAIR_RTOL), name


def test_param_gather_gradient_lands_as_the_rank_rows(runs):
    t = pair_inputs()
    w = t["w"].clone().requires_grad_()
    sum((t["rows"][r] @ w.T).pow(2).sum() for r in range(2)).backward()
    assert _rel_close(runs["ranks"]["pairs"]["fsdp"], w.grad[:2], PAIR_RTOL)


def test_max_has_no_gradient(runs):
    m, requires_grad = runs["ranks"]["pairs"]["max"]
    assert not requires_grad
    assert torch.equal(m, pair_inputs()["a"].amax(0))


@pytest.mark.parametrize("op,name", [("all_reduce", "reduce_enter"),
                                     ("all_gather", "gather")])
def test_funcol_registered_backward_overcounts(runs, op, name):
    """What the pairs replace: the registered backward of the functional
    collectives gives each rank the gradient times the number of ranks."""
    got = runs["ranks"]["pairs"]["funcol"][op]
    want = pair_functions()[name][1](pair_inputs())[0][0]
    assert _rel_close(got, 2 * want, PAIR_RTOL)
    assert not _rel_close(got, want, 0.5)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_of_one_equals_the_unsharded_step(runs, arch):
    got, want = runs["ranks"][(1, 1)][arch], runs["port"][arch, "bf16"]
    assert torch.equal(got["loss"], want["loss"])
    assert len(got["grads"]) == len(want["grads"])
    assert all(torch.equal(a, b) for a, b in zip(got["grads"],
                                                   want["grads"]))
    assert len(got["leaves"]) == len(want["leaves"])
    assert all(torch.equal(a, b) for a, b in zip(got["leaves"],
                                                   want["leaves"]))
    assert set(got["metrics"]) == set(want["metrics"])
    assert all(torch.equal(got["metrics"][k], want["metrics"][k])
               for k in want["metrics"])


def _held(got, want, arrays, arch):
    tol = GRAD_TOL
    assert abs(float(got["loss"]) - float(want["loss"])) <= (
        LOSS_RTOL * abs(float(want["loss"])))
    close_leaves(got["grads"], want["grads"], tol, "grads")
    gm, wm = got["metrics"], want["metrics"]
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= (
        NORM_RTOL * float(wm["grad_norm"]))
    assert torch.equal(gm["lr"], wm["lr"])
    check_step(got["leaves"], want["leaves"], arrays, float(wm["lr"]), tol,
               arch)


@pytest.mark.parametrize("shape", [(1, 4), (1, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", NARROW)
def test_narrow_meshes_equal_the_unsharded_port(runs, shape, arch):
    _held(runs["ranks"][shape][arch], runs["port"][arch, "f32"],
          old_params(runs["arrays"][arch]), arch)
    assert runs["ranks"][shape][arch]["layout_ok"]


def test_accum_2_equals_the_unsharded_accum_2(runs):
    _held(runs["ranks"]["pairs"]["accum"], runs["port"]["accum"],
          old_params(runs["arrays"][ACCUM_ARCH]), ACCUM_ARCH)


def _spawned(runs, key):
    """The rank-0 result ``key`` from whichever spawn ran it."""
    for spawned in (runs["ranks"]["pairs"], runs["ranks"][(1, 4)]):
        if key in spawned:
            return spawned[key]
    raise KeyError(key)


@pytest.mark.parametrize("case", FEW_ROWS,
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[2]}-{c[1]}")
def test_rows_that_data_does_not_split_equal_the_unsharded_step(runs, case):
    shape, arch, _ = case
    got = _spawned(runs, ("few", shape))
    _held(got, runs["port"]["few", arch], old_params(runs["arrays"][arch]),
          arch)
    assert int(got["metrics"]["tokens"]) == int(
        runs["port"]["few", arch]["metrics"]["tokens"])


@pytest.mark.parametrize("shape", SPAN_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_token_groups_and_loss_are_each_data_rank_rows(runs, shape):
    """The reference's microbatches, whatever the batch shards: each
    microbatch's token group spans them, its capacity and dropped
    dispatches are the whole microbatch's, and its loss divides by its
    whole label count (the rows carry different counts)."""
    got = _spawned(runs, ("span", shape))
    want, own = runs["port"]["span"], runs["port"]["span_own"]
    arrays = old_params(runs["arrays"][ACCUM_ARCH])
    _held(got, want, arrays, ACCUM_ARCH)
    jx = runs["port"]["span_jax"]
    assert abs(float(got["loss"]) - jx["loss"]) <= (
        JAX_LOSS_RTOL * abs(jx["loss"]))
    close_leaves(got["grads"], jx["grads"], JAX_GRAD_TOL, "grads")
    assert abs(float(got["metrics"]["grad_norm"])
               - jx["metrics"]["grad_norm"]) <= (
        JAX_LOSS_RTOL * jx["metrics"]["grad_norm"])
    check_step(got["leaves"], jx["leaves"], arrays, jx["metrics"]["lr"],
               JAX_GRAD_TOL, "jax")
    # each batch shard's rows as their own microbatches give another step
    assert abs(float(own["loss"]) - float(want["loss"])) > (
        LOSS_RTOL * abs(float(want["loss"])))
    with pytest.raises(AssertionError):
        close_leaves(own["grads"], want["grads"], GRAD_TOL, "grads")


def _band(a, b) -> tuple:
    """(largest difference over largest |b|, norm of the difference over
    the norm of b)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    top, norm = np.abs(b).max(), np.linalg.norm(b)
    if top == 0.0:
        return (0.0 if np.abs(a).max() == 0.0 else math.inf,) * 2
    return (np.abs(a - b).max() / top, np.linalg.norm(a - b) / norm)


def test_bf16_state_within_the_unsharded_bf16_band(runs):
    got, want = runs["ranks"][(1, 4)]["bf16"], runs["port"]["bf16"]
    f32 = runs["port"]["bf16_f32"]
    assert abs(float(got["loss"]) - float(want["loss"])) <= (
        BF16_LOSS_RTOL * abs(float(want["loss"])))
    for i, (a, b, c) in enumerate(zip(got["grads"], want["grads"],
                                      f32["grads"])):
        band = _band(b.float(), c)
        dist = _band(a.float(), b.float())
        assert all(d <= 2 * w + BF16_FLOOR for d, w in zip(dist, band)), (
            i, dist, band)
    n = (len(want["leaves"]) - 1) // 3
    assert all(t.dtype == torch.bfloat16
               for t in got["leaves"][n:3 * n]), "bf16 moments"
    assert got["layout_ok"]


def test_compressed_step_uses_the_global_int8_scale(runs):
    got, want = runs["ranks"]["pairs"]["compress"], runs["port"]["compress"]
    b1, n = 0.9, len(got["grads"])

    def dequantized(res):
        clip = min(1.0, 1.0 / max(float(res["metrics"]["grad_norm"]), 1e-9))
        return [m.double().numpy() / ((1 - b1) * clip)
                for m in res["leaves"][n:2 * n]]

    ef = got["leaves"][3 * n + 1:]
    assert len(ef) == n
    for d, dw, e, g in zip(dequantized(got), dequantized(want), ef,
                           got["grads"]):
        if not np.abs(d).max():
            continue
        scale = np.abs(d).max() / 127
        q = d / scale
        assert np.abs(q - np.rint(q)).max() <= 1e-3
        assert abs(scale - np.abs(dw).max() / 127) <= SCALE_RTOL * scale
        x = e.double().numpy() + d
        g = g.double().numpy()
        assert np.abs(x - g).max() <= 1e-6 * np.abs(g).max()


def test_checkpoint_restores_onto_other_meshes(runs):
    pairs, one = runs["ranks"]["pairs"], runs["ranks"][(1, 1)]
    at, restored, same_placements = pairs["restored21"]
    assert at == 1 and same_placements
    assert all(torch.equal(a, b) for a, b in zip(restored, pairs["saved"]))
    at, restored = one["restored11"]
    assert at == 1
    assert all(torch.equal(a, b) for a, b in zip(restored, pairs["saved"]))
    got, want = one["after11"], runs["port"]["after11"]
    assert len(got["leaves"]) == len(want["leaves"])
    assert all(torch.equal(a, b) for a, b in zip(got["leaves"],
                                                   want["leaves"]))
    assert int(got["leaves"][-1]) == 2
    assert all(torch.equal(got["metrics"][k], want["metrics"][k])
               for k in want["metrics"])
    got, want = pairs["after21"], runs["port"]["after11"]
    tol = GRAD_TOL
    assert abs(float(got["loss"]) - float(want["loss"])) <= (
        LOSS_RTOL * abs(float(want["loss"])))
    close_leaves(got["grads"], want["grads"], tol, "grads")
    gm, wm = got["metrics"], want["metrics"]
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= (
        NORM_RTOL * float(wm["grad_norm"]))
    n = len(want["grads"])
    close_leaves(got["leaves"][n:2 * n], want["leaves"][n:2 * n], tol, "mu")
    close_leaves(got["leaves"][2 * n:3 * n], want["leaves"][2 * n:3 * n],
                 2 * tol, "nu")
    assert int(got["leaves"][-1]) == int(want["leaves"][-1]) == 2
    lr = float(wm["lr"])
    for i in range(n):
        assert held_later_update(
            *(_np64(t) for t in (got["leaves"][i], want["leaves"][i],
                                 pairs["saved"][i], want["leaves"][n + i],
                                 want["leaves"][2 * n + i],
                                 want["grads"][i])), 2, lr, tol), i


def _np64(t) -> np.ndarray:
    return t.double().numpy()


def held_later_update(got_p, want_p, old_p, want_mu, want_nu, g, step: int,
                      lr: float, tol: float) -> bool:
    """The params after AdamW step ``step`` > 1 within the module
    docstring's bound."""
    b1, b2, eps = 0.9, 0.95, 1e-8
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    dg = tol * np.abs(g).max()
    s = np.sqrt(want_nu / c2)
    dv = (1 - b2) * (2 * np.abs(g) * dg + dg * dg) / c2
    ds = np.minimum(np.sqrt(dv), dv / np.maximum(2 * s, 1e-30))
    du = ((1 - b1) * dg / c1 / (s + eps)
          + np.abs(want_mu / c1) * ds / (s + eps) ** 2)
    bound = (lr * du + 1e-4 * np.abs(want_p - old_p).max()
             + 1e-6 * np.abs(want_p))
    return bool((np.abs(got_p - want_p) <= bound).all())


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(COUNT_LAYERS))
def test_dry_run_counts_what_the_collectives_move(runs, shape, arch):
    from repro_torch.configs import Shape
    from repro_torch.launch import MeshShape
    from repro_torch.launch.dryrun import shards_collectives
    from repro_torch.sharding import make_rules
    from test_torch_tp_train import B, S
    cfg = count_cfg(arch)
    rules = make_rules(MeshShape(shape, ("data", "model")))
    cell = Shape("train_4k", S, B, "train")
    settings = {"accum": COUNT_ACCUM}
    counted = shards_collectives(cfg, rules, cell, settings)
    counted["all-reduce"] -= 4     # the squared norm, DTensor's reduction
    moved = runs["ranks"]["pairs"]["moved"][shape, arch]
    assert counted == moved
    assert moved["all-reduce" if shape[1] > 1 else "all-gather"] > 0
