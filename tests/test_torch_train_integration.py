"""The port's own versions of the three behaviours that
``test_train_integration.py`` describes, on the reduced olmo with that
file's numbers: the loss decreases by more than 0.2 over 60 steps on the
planted-structure stream (mean of the first 10 against the last 10),
accum 2 matches accum 1 on one batch (loss within rtol 2e-2, params within
rtol 0.1 / atol 2e-3), and ``FaultTolerantLoop`` with a failure injected at
the 7th call ends at step 12 with finite losses, after restoring the
checkpoint of step 5.  The port runs as trained: bf16 compute, remat
``full``.  (The JAX package's own three tests fail before reaching their
checks with JAX releases whose ``make_rules(mesh_for_devices(1))`` builds
a mesh with Explicit axes, which ``with_sharding_constraint`` rejects.)

The ``*_with_rules`` tests run the same three behaviours, with the same
numbers, under the port's rules installed as the reference's tests install
theirs: ``make_rules(mesh_for_devices(1, device="cpu"))`` over a ``gloo``
process group of one spawned rank (``torch_ranks.spawn``), the state in
``DTensor`` shards and the data-parallel step; the fault loop checkpoints
and restores that sharded state."""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.data import TokenPipeline
from repro_torch.optim import AdamWConfig
from repro_torch.models.params import param_shapes
from repro_torch.pytree import tree_leaves
from repro_torch.runtime import FaultTolerantLoop
from repro_torch.train import build_train_step, init_train_state
from test_torch_train import one_thread  # noqa: F401
from torch_ranks import gathered, spawn


def _setup(steps=60, rules=None):
    cfg = get_reduced("olmo_1b")
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps,
                      weight_decay=0.01)
    step = build_train_step(cfg, opt, rules=rules)
    state = init_train_state(cfg, 0, opt_cfg=opt, device="cpu", rules=rules)
    pipe = TokenPipeline(cfg, global_batch=8, seq_len=64, seed=0)
    return cfg, step, state, pipe


def _losses(rules=None):
    cfg, step, state, pipe = _setup(rules=rules)
    losses = []
    for s in range(60):
        state, metrics = step(state, pipe.batch_at(s))
        losses.append(float(metrics["loss"]))
    return losses


def _accum_pairs(rules=None):
    cfg = get_reduced("olmo_1b")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = TokenPipeline(cfg, global_batch=8, seq_len=32,
                          seed=1).batch_at(0)
    s1 = init_train_state(cfg, 0, opt_cfg=opt, device="cpu", rules=rules)
    s2 = init_train_state(cfg, 0, opt_cfg=opt, device="cpu", rules=rules)
    s1, m1 = build_train_step(cfg, opt, accum=1, rules=rules)(s1, batch)
    s2, m2 = build_train_step(cfg, opt, accum=2, rules=rules)(s2, batch)
    return (float(m1["loss"]), float(m2["loss"]),
            list(zip(gathered(s1.params), gathered(s2.params))))


def _fault_loop(directory, rules=None):
    cfg, step, state, pipe = _setup(steps=20, rules=rules)
    ckpt = CheckpointManager(str(directory))
    calls = {"n": 0}
    logs = []

    def flaky_step(st, batch):
        calls["n"] += 1
        if calls["n"] == 7:
            raise RuntimeError("injected failure")
        return step(st, batch)

    loop = FaultTolerantLoop(flaky_step, pipe.batch_at, ckpt, ckpt_every=5,
                             max_retries=2)
    state, end, hist = loop.run(state, 0, 12, log_every=0, log=logs.append)
    return (end, [h["loss"] for h in hist], logs, int(state.opt.step),
            isinstance(state.params["embed"], torch.Tensor),
            type(state.params["embed"]).__name__)


def test_loss_decreases():
    losses = _losses()
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert np.isfinite(losses).all()
    assert last < first - 0.2, (first, last)


def test_grad_accum_matches_single_batch():
    cfg = get_reduced("olmo_1b")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = TokenPipeline(cfg, global_batch=8, seq_len=32,
                          seed=1).batch_at(0)
    s1 = init_train_state(cfg, 0, opt_cfg=opt, device="cpu")
    s2 = init_train_state(cfg, 0, opt_cfg=opt, device="cpu")
    s1, m1 = build_train_step(cfg, opt, accum=1)(s1, batch)
    s2, m2 = build_train_step(cfg, opt, accum=2)(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-2)
    for a, b in zip(s1.params.values(), s2.params.values()):
        if isinstance(a, dict):
            pairs = [(a[k][n], b[k][n]) for k in a for n in a[k]]
        else:
            pairs = [(a, b)]
        for x, y in pairs:
            np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                       rtol=0.1, atol=2e-3)


def test_fault_tolerant_loop_with_real_model(tmp_path):
    end, losses, logs, at, is_tensor, _ = _fault_loop(tmp_path)
    assert end == 12
    assert all(np.isfinite(v) for v in losses)
    assert "[fault] restored checkpoint at step 5" in logs
    assert at == 12
    assert is_tensor


# -- the same three behaviours with the port's rules installed ---------------
def with_rules(rank, world, out):
    from repro_torch.launch import mesh_for_devices
    from repro_torch.sharding import make_rules
    rules = make_rules(mesh_for_devices(1, device="cpu"))
    return {"losses": _losses(rules), "accum": _accum_pairs(rules),
            "fault": _fault_loop(f"{out}/ckpt", rules)}


@pytest.fixture(scope="module")
def ruled(tmp_path_factory):
    return spawn(with_rules, 1, tmp_path_factory.mktemp("rules"))[0]


def test_loss_decreases_with_rules(ruled):
    losses = ruled["losses"]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert np.isfinite(losses).all()
    assert last < first - 0.2, (first, last)
    assert losses == _losses()      # a mesh of one is the unsharded step


def test_grad_accum_matches_single_batch_with_rules(ruled):
    l1, l2, pairs = ruled["accum"]
    np.testing.assert_allclose(l1, l2, rtol=2e-2)
    assert len(pairs) == len(tree_leaves(param_shapes(
        get_reduced("olmo_1b"))))
    for x, y in pairs:
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=0.1, atol=2e-3)


def test_fault_tolerant_loop_with_real_model_with_rules(ruled):
    end, losses, logs, at, is_tensor, kind = ruled["fault"]
    assert end == 12
    assert all(np.isfinite(v) for v in losses)
    assert "[fault] restored checkpoint at step 5" in logs
    assert at == 12
    assert is_tensor and kind == "DTensor"
