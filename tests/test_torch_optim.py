"""The port's optimizer against the JAX package's on the same inputs (numpy
draws from a seed): ``adamw_update`` with f32 and with bf16 moments,
``adamw_init``, ``cosine_schedule``, ``global_norm``, ``quantize_int8``,
``dequantize_int8`` and ``ef_compress`` carried over three steps.

Tolerances, fixed before the comparison: the quantizer and the EF
residuals are exact (``torch.round`` and ``jnp.round`` both round half to
even, and every other op there is one correctly rounded f32 operation);
the schedule, the norm and the AdamW update agree to 2e-6 relative (the
libraries' ``pow``, ``cos`` and summation order may differ by an ulp or
two), with 1e-9 absolute for values that cancel to near zero; bf16
moments are held to one bf16 ulp (2**-7 relative) of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.optim import compress as JC
from repro_torch import optim as TO
from repro_torch.convert import lm_params_from_arrays

SHAPES = {"a": (7, 5), "b": {"c": (3,), "d": (2, 3, 4)}, "e": (64,)}
RTOL, ATOL = 2e-6, 1e-9


def _tree(rng, scale=1.0, shapes=SHAPES):
    return {k: _tree(rng, scale, v) if isinstance(v, dict)
            else (rng.standard_normal(v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, **tol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), **(tol or dict(
            rtol=RTOL, atol=ATOL)))


def _both(tree):
    return (lm_params_from_arrays(tree, device="cpu"),
            jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_equals_jax(moments):
    """Three updates from random moments at step 4, with a gradient norm
    above ``clip_norm`` so the clip acts, past the warm-up."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, mu_dtype=moments,
              nu_dtype=moments)
    tcfg, jcfg = TO.AdamWConfig(**kw), JO.AdamWConfig(**kw)
    tp, jp = _both(_tree(rng))
    tmu, jmu = _both(_tree(rng, 0.1))
    tnu, jnu = _both(jax.tree.map(np.abs, _tree(rng, 0.01)))
    dt = getattr(torch, moments)
    tst = TO.OptState(mu=jax.tree.map(lambda t: t.to(dt), tmu),
                      nu=jax.tree.map(lambda t: t.to(dt), tnu),
                      step=torch.tensor(4, dtype=torch.int32))
    jst = JO.OptState(mu=jax.tree.map(lambda a: a.astype(moments), jmu),
                      nu=jax.tree.map(lambda a: a.astype(moments), jnu),
                      step=jnp.int32(4))
    for i in range(3):
        tg, jg = _both(_tree(np.random.default_rng(10 + i), 2.0))
        tp2, tst2, tm = TO.adamw_update(tg, tst, tp, tcfg)
        jp2, jst2, jm = JO.adamw_update(jg, jst, jp, jcfg)
        assert float(jm["grad_norm"]) > tcfg.clip_norm
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL)
        assert int(tst2.step) == int(jst2.step) == 5 + i
        moment_tol = ({} if moments == "float32"
                      else dict(rtol=2 ** -7, atol=ATOL))
        _close(tst2.mu, jst2.mu, **moment_tol)
        _close(tst2.nu, jst2.nu, **moment_tol)
        if moments == "float32":
            _close(tp2, jp2)
        for t in jax.tree.leaves(tst2.mu) + jax.tree.leaves(tst2.nu):
            assert t.dtype == dt
        # the inputs are left as they were
        _close(tp, jp)
        tp, tst, jp, jst = tp2, tst2, jp2, jst2
    if moments == "bfloat16":
        _close(tp, jp, rtol=1e-4, atol=1e-6)


def test_adamw_init_matches_jax():
    tp, jp = _both(_tree(np.random.default_rng(1)))
    cfg = dict(mu_dtype="bfloat16")
    ts, js = (TO.adamw_init(tp, TO.AdamWConfig(**cfg)),
              JO.adamw_init(jp, JO.AdamWConfig(**cfg)))
    assert int(ts.step) == int(js.step) == 0
    assert ts.step.dtype == torch.int32
    for t, j in zip(jax.tree.leaves(ts.mu) + jax.tree.leaves(ts.nu),
                    jax.tree.leaves(js.mu) + jax.tree.leaves(js.nu)):
        assert tuple(t.shape) == j.shape and not t.any()
        assert str(t.dtype).split(".")[-1] == str(j.dtype)


def test_cosine_schedule_equals_jax():
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    tcfg, jcfg = TO.AdamWConfig(**kw), JO.AdamWConfig(**kw)
    for s in range(0, 60):
        np.testing.assert_allclose(
            float(TO.cosine_schedule(tcfg, torch.tensor(s, dtype=torch.int32))),
            float(JO.cosine_schedule(jcfg, jnp.int32(s))), rtol=RTOL,
            atol=1e-12)


def test_global_norm_equals_jax():
    tt, jt = _both(_tree(np.random.default_rng(2), 3.0))
    np.testing.assert_allclose(float(TO.global_norm(tt)),
                               float(JO.global_norm(jt)), rtol=RTOL)


def test_quantize_int8_equals_jax_exactly():
    rng = np.random.default_rng(3)
    cases = [rng.standard_normal(1000).astype(np.float32) * 0.3,
             # halves exactly: 127 sets scale 1, then round half to even
             np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32),
             np.zeros(5, np.float32)]
    for x in cases:
        tq, ts = TO.quantize_int8(torch.from_numpy(x))
        jq, js = JO.quantize_int8(jnp.asarray(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            TO.dequantize_int8(tq, ts).numpy(),
            np.asarray(JO.dequantize_int8(jq, js)))
        assert int(tq.abs().max()) <= 127


def test_ef_compress_equals_jax_exactly():
    """Three compressed steps with the residual carried: the compressed
    gradients and the residuals are the reference's bit for bit."""
    tp, jp = _both(_tree(np.random.default_rng(4)))
    tr, jr = TO.ef_init(tp), JC.ef_init(jp)
    for i in range(3):
        tg, jg = _both(_tree(np.random.default_rng(20 + i), 0.01))
        tg2, tr = TO.ef_compress(tg, tr)
        jg2, jr = JO.ef_compress(jg, jr)
        for a, b in zip(jax.tree.leaves(tg2) + jax.tree.leaves(tr),
                        jax.tree.leaves(jg2) + jax.tree.leaves(jr)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
