"""The port's training path against the JAX package's: ``loss_fn`` and its
gradient (``jax.value_and_grad(repro.models.loss_fn)``), the remat modes,
and one whole ``build_train_step`` step (accum 1 and 2, and with int8+EF
compression) against the JAX package's ``build_train_step(cfg, None,
opt)``, for the ``reduced()`` config of each arch.  This file holds the
dense attention archs and the helpers; ``test_torch_train_variants.py``
(sliding window, multimodal prefix, MoE) and
``test_torch_train_recurrent.py`` hold the others, so that no file of the
``--dist loadfile`` run takes much over a minute.

The JAX package's weights go across with ``lm_params_from_arrays`` (its
init; jamba, rwkv6 and whisper on ``test_torch_models.randomized`` leaves,
so that no zero-initialised leaf hides a term of the backward), the batch
from ``TokenPipeline(cfg, 4, 32, seed=0)`` in both packages.

Tolerances, fixed before the comparison:

- f32 compute (``COMPUTE_DTYPE`` patched to f32 in both packages): the loss
  within 1e-5; every gradient leaf within 1e-4 of that leaf's largest |g|
  (a leaf the loss does not use is zero in both).
- bf16 as trained: held to the reference's own rounding band, as
  ``test_torch_lm.py`` holds bf16 logits, leaf by leaf.  A leaf's distance
  from the reference's f32 gradient is read two ways: its largest
  difference over the gradient's largest |g|, and the norm of the
  difference over the gradient's norm.  Each way, the port's distance for
  each leaf is at most twice the reference's bf16 distance for the same
  leaf, plus 2**-8 (bf16's rounding at the leaf's largest value).  A leaf
  the loss does not use is zero in both.  The loss is a mean of per-token
  cross-entropies: its distance from the reference's f32 loss is at most
  twice the largest per-token distance of the reference's bf16
  cross-entropy (from its ``forward`` logits) from its f32 one.
  The MoE archs' bf16 gradients are dominated by the tokens whose experts
  differ from f32 routing: a few dispatches out of hundreds flip, each
  package its own few, and how many varies from batch to batch by a factor
  of two or more.  So in bf16 the port replays the experts that the
  reference's bf16 loss chose at each router call, in call order,
  weighting them by its own gates (as ``chip_smoke.py``'s prefill/decode
  check replays ``forward``'s experts); a replay that runs out of choices
  or is left with some, or disagrees with the port's own choice on more
  than a tenth of the dispatches, fails.  The bands read
  (``tools/train_bf16_bands.py``), smallest to largest leaf, largest
  difference / norm: olmo 0.010-0.015 / 0.013-0.017, gemma 0.009-0.026 /
  0.011-0.018, phi3 0.008-0.020 / 0.007-0.017, h2o-danube 0.010-0.020 /
  0.007-0.016, paligemma 0.011-0.017 / 0.011-0.016, qwen3-moe 0.04-0.25 /
  0.03-0.10, dbrx 0.016-0.18 / 0.020-0.087, jamba 0.06-0.57 / 0.06-0.20,
  rwkv6 0.014-0.23 / 0.011-0.16, whisper 0.008-0.031 / 0.013-0.031; the
  port's largest ratio to its leaf's band is 1.66 / 1.22.  So a leaf that
  is zeroed (norm distance 1) or has its sign flipped (2) fails on every
  arch.
- remat ``none`` / ``dots`` / ``full`` (the port alone, f32): the losses
  equal and every gradient leaf within 1e-6 of its largest |g|.
- one train step, f32 compute: ``lr`` within 1e-6 relative, ``grad_norm``
  and the loss within 1e-5 relative, ``tokens`` exact; ``mu`` within 1e-4
  and ``nu`` within 2e-4 of the leaf's largest value (both follow the
  gradient, nu its square); the params elementwise within
  ``lr * min(2, eps * dg / (|g| + eps)**2) + 1e-4 * max|dp|``, where ``g``
  is the reference's clipped gradient (its ``mu / (1 - b1)``), ``dg`` the
  gradient tolerance above and ``dp`` the leaf's update: AdamW's first step
  is ``lr * g / (|g| + eps)``, which turns a gradient near zero into any
  value in (-lr, lr), so a gradient within tolerance moves such a param by
  up to that bound, and every other param by the update's rounding.
  With compression both packages quantize their own gradients; where the
  reference's ``x / scale`` lies within the gradient tolerance of a
  half-integer the two may round to neighbouring ``q``.  So ``q`` (read
  back as ``mu / ((1 - b1) * clip * scale)``) may differ by one step
  there and nowhere else; each package's ``grad_norm`` is that of its own
  quantized gradients (1e-5 relative), and ``mu``, ``nu``, the params and
  the EF
  residual are held as above where ``q`` is equal (the residual within
  twice the gradient tolerance), the residual within one quantization step
  more where it is not.  Every param bound adds 1e-6 of the param (f32
  rounding of the update).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unittest import mock

from repro import models as J
from repro import optim as JO
from repro import train as JT
from repro.configs import get_reduced as jax_get_reduced
from repro.data import TokenPipeline as JaxPipeline
from repro.models import lm as JLM
from repro_torch import models as T
from repro_torch import optim as TO
from repro_torch import train as TT
from repro_torch.configs import get_reduced
from repro_torch.convert import (lm_params_from_arrays,
                                 train_state_from_arrays,
                                 train_state_to_arrays)
from repro_torch.data import TokenPipeline
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TMOE
from repro_torch.pytree import tree_leaves, tree_unflatten
from test_torch_models import randomized

CPU = torch.device("cpu")
B, S = 4, 32
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
BF16_FLOOR = 2.0 ** -8
REPLAY_AGREE = 0.9
RANDOMIZED = ("jamba_v01_52b", "rwkv6_1p6b", "whisper_small")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = [(1, False), (2, False), (1, True)]
DENSE_ARCHS = ("olmo_1b", "gemma_7b", "phi3_medium_14b")


def _dtypes(dt: str):
    return {"float32": (torch.float32, jnp.float32),
            "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dt]


@contextlib.contextmanager
def compute_dtype(dt: str):
    """Both packages' compute dtype patched to ``dt``."""
    tdt, jdt = _dtypes(dt)
    with mock.patch.object(TLM, "COMPUTE_DTYPE", tdt), \
            mock.patch.object(JLM, "COMPUTE_DTYPE", jdt):
        yield


def port_value_and_grad(params, cfg, batch, remat="dots"):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = T.loss_fn(tree_unflatten(params, leaves), cfg, batch,
                              remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), int(metrics["tokens"]), [
        np.zeros(tuple(p.shape)) if g is None else g.double().numpy()
        for p, g in zip(leaves, grads)]


def jax_value_and_grad(params, cfg, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: J.loss_fn(p, cfg, batch), has_aux=True))(params)
    return float(loss), int(metrics["tokens"]), [
        np.asarray(g, np.float64) for g in jax.tree.leaves(grads)]


def make_case(arch: str) -> dict:
    """Both packages' params (the same values), config and batch."""
    cfg, jcfg = get_reduced(arch), jax_get_reduced(arch)
    leaves = jax.tree.map(np.asarray, J.init_params(
        jcfg, jax.random.PRNGKey(0)))
    if arch in RANDOMIZED:
        leaves = randomized(leaves, np.random.default_rng(7))
    batch = TokenPipeline(cfg, B, S, seed=0).batch_at(0)
    jbatch = JaxPipeline(jcfg, B, S, seed=0).batch_at(0)
    assert all(np.array_equal(batch[k], jbatch[k]) for k in jbatch)
    case = {"arch": arch, "cfg": cfg, "jcfg": jcfg, "batch": batch,
            "jbatch": {k: jnp.asarray(v) for k, v in jbatch.items()},
            "jparams": jax.tree.map(jnp.asarray, leaves),
            "tparams": lm_params_from_arrays(leaves, device=CPU)}
    with compute_dtype("float32"):
        case["float32"] = (port_value_and_grad(case["tparams"], cfg, batch),
                           jax_value_and_grad(case["jparams"], jcfg,
                                              case["jbatch"]))
    with compute_dtype("bfloat16"):
        with replayed_routing(jax_routing(case)):
            port = port_value_and_grad(case["tparams"], cfg, batch)
        case["bfloat16"] = (port, jax_value_and_grad(case["jparams"], jcfg,
                                                     case["jbatch"]))
    return case


def jax_routing(case) -> list[np.ndarray]:
    """The experts (T, k) that the reference's router chose at each call
    of its loss, in call order, in the compute dtype in force."""
    calls, top_k = [], jax.lax.top_k

    def recorded(gates, k):
        w, i = top_k(gates, k)
        jax.debug.callback(lambda a: calls.append(np.asarray(a)), i,
                           ordered=True)
        return w, i

    with mock.patch.object(jax.lax, "top_k", recorded):
        jax.block_until_ready(jax.jit(lambda p: J.loss_fn(
            p, case["jcfg"], case["jbatch"]))(case["jparams"]))
        jax.effects_barrier()
    return calls


@contextlib.contextmanager
def replayed_routing(calls: list[np.ndarray]):
    """The port's router takes the experts of ``calls`` in call order,
    weighted by its own gates as ``moe.route`` weights them.  A group
    recomputed in the backward sees the same tokens and gets the same
    experts again."""
    queue, seen, agree = list(calls), {}, [0, 0]

    def replay(xt, p, cfg, router_bits=None):
        key = xt.detach().float().numpy().tobytes()
        gates = torch.softmax(xt.float() @ p["w_router"].float(), dim=-1)
        if key not in seen:
            assert queue, "the port routed more often than the reference"
            seen[key] = torch.tensor(queue.pop(0), dtype=torch.int64)
            # outside autograd: a recomputation saves what the forward did
            own = torch.topk(gates.detach(), cfg.experts_per_token)[1]
            agree[0] += int((own.sort(-1)[0] == seen[key].sort(-1)[0]).sum())
            agree[1] += own.numel()
        top_i = seen[key]
        top_w = gates.gather(1, top_i)
        return top_w / torch.clamp_min(top_w.sum(-1, keepdim=True),
                                       1e-9), top_i

    with mock.patch.object(TMOE, "route", replay):
        yield
    assert not queue, "the port routed less often than the reference"
    assert agree[0] >= REPLAY_AGREE * agree[1], agree


def _rel(a, b, ref):
    return np.abs(a - b).max() / max(np.abs(ref).max(), 1e-30)


def _rel_norm(a, b, ref):
    return np.linalg.norm(a - b) / max(np.linalg.norm(ref), 1e-30)


def check_f32(case):
    (tl, tn, tg), (jl, jn, jg) = case["float32"]
    assert tn == jn
    assert abs(tl - jl) <= LOSS_TOL, (tl, jl)
    assert len(tg) == len(jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape
        if not np.abs(b).max():
            assert not np.abs(a).max(), i
            continue
        assert _rel(a, b, b) <= GRAD_TOL, (i, _rel(a, b, b))


def jax_token_ce(case) -> np.ndarray:
    """The reference's per-token cross-entropy (B, S_text) from its
    ``forward`` logits, in the compute dtype in force."""
    jcfg, jb = case["jcfg"], case["jbatch"]
    kw = {k: jb[n] for k, n in (("frontend", "patches"), ("frames", "frames"))
          if n in jb}
    logits = jax.jit(lambda p, t, kw: J.forward(p, jcfg, t, **kw))(
        case["jparams"], jb["tokens"], kw).astype(jnp.float32)
    logits = logits[:, jcfg.frontend_tokens:]
    gold = jnp.take_along_axis(logits, jb["labels"][..., None], -1)[..., 0]
    return np.asarray(jax.nn.logsumexp(logits, -1) - gold, np.float64)


def check_bf16(case):
    """The loss, a mean of per-token cross-entropies, within twice the
    largest per-token distance of the reference's bf16 cross-entropy from
    its f32 one; each gradient leaf within twice the reference's own bf16
    distance for that leaf, as the module docstring says."""
    tl, _, tg = case["bfloat16"][0]
    rl, _, rg = case["float32"][1]
    _, _, jg = case["bfloat16"][1]
    ce = {}
    for dt in ("float32", "bfloat16"):
        with compute_dtype(dt):
            ce[dt] = jax_token_ce(case)
    np.testing.assert_allclose(ce["float32"].mean(), rl, rtol=1e-6)
    loss_band = np.abs(ce["bfloat16"] - ce["float32"]).max()
    assert abs(tl - rl) <= 2 * loss_band, (tl, rl, loss_band)
    for i, (a, b, r) in enumerate(zip(tg, jg, rg)):
        if not np.abs(r).max():
            assert not np.abs(a).max(), i
            continue
        for dist in (_rel, _rel_norm):
            band, err = dist(b, r, r), dist(a, r, r)
            assert band > 0 and err <= 2 * band + BF16_FLOOR, (
                i, dist.__name__, err, band)


def check_remat(case):
    cfg = case["cfg"]
    with compute_dtype("float32"):
        runs = [port_value_and_grad(case["tparams"], cfg, case["batch"],
                                    remat=r) for r in ("none", "dots",
                                                        "full")]
    (l0, _, g0) = runs[0]
    for loss, _, grads in runs[1:]:
        assert loss == l0
        for a, b in zip(grads, g0):
            assert np.abs(a - b).max() <= REMAT_TOL * np.abs(b).max()


def _np64(x):
    return np.asarray(x, np.float64)


def _held_update(got_p, want_p, old_p, want_mu, lr, eps, b1, keep=None):
    """Params elementwise within the bound of the module docstring; with
    ``keep`` only where it is true."""
    g = want_mu / (1 - b1)
    dg = GRAD_TOL * np.abs(g).max()
    bound = (lr * np.minimum(2.0, eps * dg / (np.abs(g) + eps) ** 2)
             + 1e-4 * np.abs(want_p - old_p).max() + 1e-6 * np.abs(want_p))
    ok = np.abs(got_p - want_p) <= bound
    if keep is not None:
        ok |= ~keep
    return bool(ok.all())


def run_step(case, accum: int, compress: bool):
    """One step of both packages from the same state, f32 compute."""
    jopt, topt = JO.AdamWConfig(**OPT), TO.AdamWConfig(**OPT)
    js = JT.TrainState(params=case["jparams"],
                       opt=JO.adamw_init(case["jparams"], jopt),
                       ef=(JO.compress.ef_init(case["jparams"]) if compress
                           else None))
    ts = train_state_from_arrays(jax.tree.map(np.asarray, js), device=CPU)
    with compute_dtype("float32"):
        js2, jm = jax.jit(JT.build_train_step(
            case["jcfg"], None, jopt, accum=accum, compress=compress))(
                js, case["jbatch"])
        ts2, tm = TT.build_train_step(case["cfg"], topt, accum=accum,
                                      compress=compress)(ts, case["batch"])
    return js, js2, jm, ts2, tm, topt


def check_step(case, accum: int, compress: bool):
    js, js2, jm, ts2, tm, opt = run_step(case, accum, compress)
    assert set(tm) == set(jm)
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    # with compression the norm is of each package's own quantized
    # gradients, held below against its own q
    for k in ("loss",) if compress else ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    if "tokens" in jm:
        assert int(tm["tokens"]) == int(jm["tokens"])
    assert int(ts2.opt.step) == int(js2.opt.step) == 1
    got = train_state_to_arrays(ts2)
    lr = float(jm["lr"])
    clip = min(1.0, opt.clip_norm / max(float(jm["grad_norm"]), 1e-9))
    tclip = min(1.0, opt.clip_norm / max(float(tm["grad_norm"]), 1e-9))
    n = len(jax.tree.leaves(js2.params))
    sq = {"port": 0.0, "jax": 0.0}
    groups = zip(jax.tree.leaves(got.params), jax.tree.leaves(js2.params),
                 jax.tree.leaves(js.params), jax.tree.leaves(got.opt.mu),
                 jax.tree.leaves(js2.opt.mu), jax.tree.leaves(got.opt.nu),
                 jax.tree.leaves(js2.opt.nu),
                 jax.tree.leaves(got.ef) if compress else [None] * n,
                 jax.tree.leaves(js2.ef) if compress else [None] * n)
    for i, (tp, jp, op, tmu, jmu, tnu, jnu, tef, jef) in enumerate(groups):
        tp, jp, op, tmu, jmu, tnu, jnu = map(_np64, (tp, jp, op, tmu, jmu,
                                                     tnu, jnu))
        keep = None
        if compress and np.abs(jmu).max():
            # q read back from mu; the scale is max|q * scale| / 127
            jx = jmu / ((1 - opt.b1) * clip)
            tx = tmu / ((1 - opt.b1) * tclip)
            js_, ts_ = np.abs(jx).max() / 127, np.abs(tx).max() / 127
            jq, tq = np.rint(jx / js_), np.rint(tx / ts_)
            assert np.abs(jq - tq).max() <= 1, i
            # the reference's x before quantizing: q * scale + residual
            x = jq * js_ + _np64(jef)
            frac = np.abs(np.abs(x / js_) % 1.0 - 0.5)
            near = frac <= GRAD_TOL * np.abs(x).max() / js_
            assert ((jq != tq) <= near).all(), i
            keep = jq == tq
            sq["jax"] += ((jq * js_) ** 2).sum()
            sq["port"] += ((tq * ts_) ** 2).sum()
            ef_err = np.abs(_np64(tef) - _np64(jef))
            noise = 2 * GRAD_TOL * np.abs(x).max()
            assert (ef_err <= np.where(keep, noise, js_ + noise)).all(), i
        for got_m, want_m, tol in ((tmu, jmu, GRAD_TOL),
                                   (tnu, jnu, 2 * GRAD_TOL)):
            err = np.abs(got_m - want_m)
            if keep is not None:
                err = err[keep]
            assert err.size == 0 or err.max() <= tol * np.abs(want_m).max(), i
        assert _held_update(tp, jp, op, jmu, lr, opt.eps, opt.b1, keep), i
    if compress:
        for who, m in (("port", tm), ("jax", jm)):
            assert abs(float(m["grad_norm"]) - np.sqrt(sq[who])) <= (
                1e-5 * float(m["grad_norm"])), who


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's small ops in one thread: several test workers share the
    cores, and more threads than cores slow them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def case(request):
    return make_case(request.param)


def test_loss_and_grads_f32_equal_jax(case):
    check_f32(case)


def test_loss_and_grads_bf16_within_the_reference_band(case):
    check_bf16(case)


def test_remat_modes_give_equal_grads(case):
    check_remat(case)


@pytest.mark.parametrize("accum,compress", STEPS)
def test_train_step_equals_jax(case, accum, compress):
    check_step(case, accum, compress)
