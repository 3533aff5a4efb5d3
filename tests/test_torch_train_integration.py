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
a mesh with Explicit axes, which ``with_sharding_constraint`` rejects.)"""
import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.data import TokenPipeline
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FaultTolerantLoop
from repro_torch.train import build_train_step, init_train_state
from test_torch_train import one_thread  # noqa: F401


def _setup(steps=60):
    cfg = get_reduced("olmo_1b")
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps,
                      weight_decay=0.01)
    step = build_train_step(cfg, opt)
    state = init_train_state(cfg, 0, opt_cfg=opt, device="cpu")
    pipe = TokenPipeline(cfg, global_batch=8, seq_len=64, seed=0)
    return cfg, step, state, pipe


def test_loss_decreases():
    cfg, step, state, pipe = _setup()
    losses = []
    for s in range(60):
        state, metrics = step(state, pipe.batch_at(s))
        losses.append(float(metrics["loss"]))
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
    cfg, step, state, pipe = _setup(steps=20)
    ckpt = CheckpointManager(str(tmp_path))
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
    assert end == 12
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "[fault] restored checkpoint at step 5" in logs
    assert int(state.opt.step) == 12
    assert isinstance(state.params["embed"], torch.Tensor)
