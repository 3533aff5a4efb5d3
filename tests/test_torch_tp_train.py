"""The tensor-parallel train step over a ("data", "model") ``DeviceMesh`` on
``gloo`` ranks on the CPU: ``build_train_step(..., rules=make_rules(mesh))``
and ``train.sharded_grads`` on meshes (1, 2) and (2, 2), for every
configuration, against the port's unsharded step and the JAX package's
unsharded ``build_train_step(cfg, None, opt)``.

The sharded step is the reference's (``build_train_step``'s docstring):
each microbatch's loss and MoE token groups are the whole microbatch's
wherever its rows lie, so the references on both meshes are the unsharded
steps with the same ``accum`` (1).

One spawn per mesh (``torch_ranks.spawn``, one torch thread a rank),
running in a thread while the parent makes the references.  Every rank
takes the same state: the JAX package's init params (jamba, rwkv6 and
whisper on ``test_torch_models.randomized`` leaves, so that no
zero-initialised leaf hides a term of the backward), zero moments, f32;
the batch is ``TokenPipeline(cfg, 4, 32, seed=0)``'s; AdamW as
``test_torch_train.py`` (lr 1e-3, warm-up 2 of 10); f32 compute
(``COMPUTE_DTYPE`` patched in each package).

What is held, and how closely (fixed before the first run):

- against the port's unsharded step: the loss within 1e-6 relative;
  every gradient leaf (``sharded_grads``, gathered whole) within
  ``GRAD_TOL`` (1e-5) of the leaf's largest |g|; after the step
  ``grad_norm`` within 1e-5 relative,
  ``lr`` equal, ``mu`` within the gradient tolerance and ``nu`` within
  twice it of the leaf's largest value, and the params elementwise within
  ``test_torch_train.py``'s bound for AdamW's first step (``lr *
  min(2, eps * dg / (|g| + eps)**2)`` plus 1e-4 of the leaf's largest
  update plus 1e-6 of the param, ``dg`` the gradient tolerance), since
  that step turns a gradient near zero into any update in (-lr, lr);
- against the JAX package at ``test_torch_train.py``'s f32 tolerances:
  the loss within 1e-5 relative, every gradient leaf within 1e-4 of the
  leaf's largest |g| (the reference's gradient read from its ``mu``:
  ``mu / ((1 - b1) * clip)``), ``mu`` within 1e-4 and ``nu`` within 2e-4,
  the params within the bound above with ``dg`` at 1e-4;
- every rank's state after the step: each param, ``mu`` and ``nu`` leaf a
  ``DTensor`` with the local shape and placements of ``input_specs``'
  spec on that mesh.

``test_torch_tp_train_meshes.py`` holds the collectives' backwards, the
mesh of one (bit for bit), meshes (1, 4) and (1, 3), accumulation, bf16
state, compression and checkpoints.
"""
import concurrent.futures
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import TokenPipeline
from torch_ranks import gathered, spawn

# the spawned ranks import this module: JAX is imported only where the
# parent uses it

ARCHS = ("olmo_1b", "gemma_7b", "h2o_danube_1p8b", "phi3_medium_14b",
         "paligemma_3b", "qwen3_moe_235b_a22b", "dbrx_132b",
         "jamba_v01_52b", "rwkv6_1p6b", "whisper_small")
RANDOMIZED = ("jamba_v01_52b", "rwkv6_1p6b", "whisper_small")
MESHES = ((1, 2), (2, 2))
ACCUM = 1
B, S = 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_RTOL = 1e-6
NORM_RTOL = 1e-5
GRAD_TOL = 1e-5
JAX_LOSS_RTOL = 1e-5
JAX_GRAD_TOL = 1e-4


def leaves(arch) -> dict:
    """The JAX package's init params as numpy arrays (randomized for the
    recurrent and encoder-decoder archs)."""
    import jax

    from repro import models as J
    from repro.configs import get_reduced as jax_get_reduced
    from test_torch_models import randomized
    jp = jax.tree.map(np.asarray, J.init_params(jax_get_reduced(arch),
                                                jax.random.PRNGKey(0)))
    return randomized(jp, np.random.default_rng(7)) if arch in RANDOMIZED \
        else jp


def batch_of(cfg, rows: int = B, masked: bool = False) -> dict:
    """``TokenPipeline(cfg, rows, S, seed=0)``'s first batch; ``masked``:
    with labels of -1 on half of row 0 and every third position of row 2,
    so that the rows carry different label counts."""
    batch = TokenPipeline(cfg, rows, S, seed=0).batch_at(0)
    if masked:
        labels = batch["labels"].copy()
        labels[0, :labels.shape[1] // 2] = -1
        labels[2, ::3] = -1
        batch["labels"] = labels
    return batch


def opt_cfg(**kw):
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(**OPT, **kw)


def state_of(arrays, cfg, rules=None, opt=None):
    """A fresh state (zero moments, step 0) on the CPU from the params
    ``arrays``; with ``rules``, each rank's shards of it."""
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, shard_state
    params = lm_params_from_arrays(arrays, device="cpu")
    state = TrainState(params=params,
                       opt=adamw_init(params, opt or opt_cfg()), ef=None)
    return state if rules is None else shard_state(state, cfg, rules)


def compute(dtype=torch.float32):
    from repro_torch.models import lm as TLM
    return mock.patch.object(TLM, "COMPUTE_DTYPE", dtype)


def run(arrays, arch, rules=None, accum: int = 1, *, dtype=torch.float32,
        compress=False, accum_dtype=torch.float32, opt=None, state=None,
        rows: int = B, masked: bool = False, edit=None):
    """The gradient (whole leaves) and one step of the port with ``accum``
    microbatches: unsharded (``rules`` None) or sharded under ``rules``;
    on ``batch_of(cfg, rows, masked)``, ``cfg`` the reduced config with
    the fields ``edit`` replaced.  Returns {"loss", "grads", "leaves"
    (after the step), "metrics", "layout_ok"}."""
    import dataclasses

    from repro_torch.pytree import tree_leaves
    from repro_torch.train import (accumulate_grads, build_train_step,
                                   sharded_grads)
    cfg = dataclasses.replace(get_reduced(arch), **(edit or {}))
    opt = opt or opt_cfg()
    if state is None:
        state = state_of(arrays, cfg, rules, opt)
        if compress:
            from repro_torch.optim.compress import ef_init
            from repro_torch.train import TrainState, shard_state
            whole = state_of(arrays, cfg, None, opt)
            whole = TrainState(whole.params, whole.opt, ef_init(whole.params))
            state = whole if rules is None else shard_state(whole, cfg, rules)
    batch = {k: torch.as_tensor(v)
             for k, v in batch_of(cfg, rows, masked).items()}
    step = build_train_step(cfg, opt, rules=rules, accum=accum,
                            compress=compress, accum_dtype=accum_dtype)
    with compute(dtype):
        if rules is None:
            grads, m = accumulate_grads(cfg, state.params, batch,
                                        accum=accum, accum_dtype=accum_dtype)
            grads = tree_leaves(grads)
        else:
            grads, m = sharded_grads(cfg, state.params, batch, rules,
                                     accum=accum, accum_dtype=accum_dtype)
            grads = [g.full_tensor() for g in tree_leaves(grads)]
        new, metrics = step(state, batch)
    out = {"loss": m["loss"].clone(), "grads": grads,
           "leaves": gathered(new),
           "metrics": {k: v.clone() for k, v in metrics.items()}}
    if rules is not None:
        from repro_torch.models import param_logical_axes
        from repro_torch.train.step import _check_shards
        for tree in (new.params, new.opt.mu, new.opt.nu):
            _check_shards(tree, param_logical_axes(cfg), rules, "state")
        out["layout_ok"] = True
    return out


def tp_ranks(rank, world, out, shape, arrays, archs):
    """Every arch on one mesh; rank 0 returns what it saw."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import make_rules
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rules = make_rules(mesh)
    res = {arch: run(arrays[arch], arch, rules) for arch in archs}
    return res if rank == 0 else None


# -- the references -------------------------------------------------------------
def jax_run(arrays, arch, accum: int, *, masked: bool = False,
            edit=None) -> dict:
    """The JAX package's unsharded step (f32 compute) from the same state,
    on ``batch_of(cfg, B, masked)`` with the config's fields ``edit``
    replaced: its loss, gradient (read from ``mu``), metrics and leaves."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import optim as JO
    from repro import train as JT
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import lm as JLM
    jcfg = dataclasses.replace(jax_get_reduced(arch), **(edit or {}))
    jopt = JO.AdamWConfig(**OPT)
    jp = jax.tree.map(jnp.asarray, arrays)
    js = JT.TrainState(params=jp, opt=JO.adamw_init(jp, jopt), ef=None)
    cfg = dataclasses.replace(get_reduced(arch), **(edit or {}))
    batch = {k: jnp.asarray(v) for k, v in batch_of(cfg, B, masked).items()}
    with mock.patch.object(JLM, "COMPUTE_DTYPE", jnp.float32):
        js2, jm = jax.jit(JT.build_train_step(jcfg, None, jopt,
                                              accum=accum))(js, batch)
    norm = float(jm["grad_norm"])
    clip = min(1.0, jopt.clip_norm / max(norm, 1e-9))
    mu = [np.asarray(t, np.float64) for t in jax.tree.leaves(js2.opt.mu)]
    return {"loss": float(jm["loss"]),
            "grads": [m / ((1 - jopt.b1) * clip) for m in mu],
            "metrics": {k: float(v) for k, v in jm.items()},
            "leaves": [np.asarray(t, np.float64)
                       for t in jax.tree.leaves(js2)]}


def references(arrays: dict, archs, accums) -> tuple:
    """The port's unsharded runs and the JAX package's, by (arch, accum)."""
    port = {(a, k): run(arrays[a], a, None, k) for a in archs for k in accums}
    jx = {(a, k): jax_run(arrays[a], a, k) for a in archs for k in accums}
    return port, jx


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """The spawns run in a thread while the references are made here."""
    arrays = {arch: leaves(arch) for arch in ARCHS}

    def spawns():
        return {shape: spawn(tp_ranks, shape[0] * shape[1],
                             tmp_path_factory.mktemp("x".join(map(str,
                                                                  shape))),
                             shape, arrays, ARCHS)[0]
                for shape in MESHES}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawns)
        port, jx = references(arrays, ARCHS, [ACCUM])
        return {"ranks": ranks.result(), "port": port, "jax": jx,
                "arrays": arrays}


# -- the checks ---------------------------------------------------------------------
def _np64(t) -> np.ndarray:
    return t.double().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float64)


def close_leaves(got, want, tol: float, what: str) -> None:
    """Each leaf within ``tol`` of the reference leaf's largest value."""
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _np64(a), _np64(b)
        assert a.shape == b.shape, (what, i)
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), (
            what, i, np.abs(a - b).max(), np.abs(b).max())


def held_update(got_p, want_p, old_p, want_mu, lr, tol) -> bool:
    """The params within the module docstring's bound for AdamW's first
    step, ``want_mu`` the reference's first moment."""
    eps, b1 = 1e-8, 0.9
    g = want_mu / (1 - b1)
    dg = tol * np.abs(g).max()
    bound = (lr * np.minimum(2.0, eps * dg / (np.abs(g) + eps) ** 2)
             + 1e-4 * np.abs(want_p - old_p).max() + 1e-6 * np.abs(want_p))
    return bool((np.abs(got_p - want_p) <= bound).all())


def check_step(got_leaves, want_leaves, old_params, lr: float, tol: float,
               what: str) -> None:
    """The state after one step against a reference's: (params, mu, nu,
    step) leaves in ``tree_leaves`` order."""
    n = len(old_params)
    assert len(got_leaves) == len(want_leaves) == 3 * n + 1, what
    params, mu, nu = (slice(i * n, (i + 1) * n) for i in range(3))
    close_leaves(got_leaves[mu], want_leaves[mu], tol, f"{what} mu")
    close_leaves(got_leaves[nu], want_leaves[nu], 2 * tol, f"{what} nu")
    for i, (a, b, o, m) in enumerate(zip(
            got_leaves[params], want_leaves[params], old_params,
            want_leaves[mu])):
        assert held_update(_np64(a), _np64(b), _np64(o), _np64(m), lr,
                           tol), (what, "param", i)
    assert int(got_leaves[-1]) == int(want_leaves[-1]) == 1, what


def old_params(arrays) -> list:
    import jax
    return [np.asarray(t, np.float64) for t in jax.tree.leaves(arrays)]


def _cases():
    return [(shape, arch) for shape in MESHES for arch in ARCHS]


def _id(case):
    return f"{case[0][0]}x{case[0][1]}-{case[1]}"


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_sharded_step_equals_the_unsharded_port(runs, case):
    shape, arch = case
    got, want = runs["ranks"][shape][arch], runs["port"][arch, ACCUM]
    tol = GRAD_TOL
    assert abs(float(got["loss"]) - float(want["loss"])) <= (
        LOSS_RTOL * abs(float(want["loss"])))
    close_leaves(got["grads"], want["grads"], tol, "grads")
    gm, wm = got["metrics"], want["metrics"]
    # one microbatch: both steps count ``tokens``, the whole batch's
    assert set(gm) == set(wm) == {"loss", "tokens", "grad_norm", "lr"}
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= (
        LOSS_RTOL * abs(float(wm["loss"])))
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= (
        NORM_RTOL * float(wm["grad_norm"]))
    assert torch.equal(gm["lr"], wm["lr"])
    assert int(gm["tokens"]) == int(wm["tokens"])
    check_step(got["leaves"], want["leaves"],
               old_params(runs["arrays"][arch]), float(wm["lr"]), tol,
               "port")


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_sharded_step_equals_jax(runs, case):
    shape, arch = case
    got, want = runs["ranks"][shape][arch], runs["jax"][arch, ACCUM]
    assert abs(float(got["loss"]) - want["loss"]) <= (
        JAX_LOSS_RTOL * abs(want["loss"]))
    close_leaves(got["grads"], want["grads"], JAX_GRAD_TOL, "grads")
    assert abs(float(got["metrics"]["grad_norm"])
               - want["metrics"]["grad_norm"]) <= (
        JAX_LOSS_RTOL * want["metrics"]["grad_norm"])
    check_step(got["leaves"], want["leaves"],
               old_params(runs["arrays"][arch]), want["metrics"]["lr"],
               JAX_GRAD_TOL, "jax")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_state_after_the_step_has_the_local_shapes_of_input_specs(runs,
                                                                  shape):
    assert all(runs["ranks"][shape][arch]["layout_ok"] for arch in ARCHS)
