"""The port's LM serving path against the JAX package's: ``forward``,
``prefill`` (last logits, KV caches, ``slot_pos``) and ``decode_step`` for
the ``reduced()`` config of each of the seven attention-family archs, with
the JAX package's weights carried across by ``lm_params_from_arrays``, the
same tokens (and paligemma's prefix patches) from ``make_batch``; then the
port's own prefill -> decode consistency with its full forward, as
``test_archs_smoke.py::test_prefill_decode_consistency`` holds the JAX
package's.

Tolerances, fixed before the comparison: logits and cache entries are bf16
and compared at ``rtol=atol=5e-2``, the JAX package's own tolerance for its
prefill/decode test (the two libraries accumulate the bf16 products in
another order and round elementwise chains at other points, so values a few
bf16 ulps apart are expected); ``slot_pos`` and the cache shapes and dtypes
are exact.  h2o-danube's reduced window (16) is shorter than the cache
(24), so its decode step wraps the ring."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as J
from repro.configs import get_reduced as jax_get_reduced
from repro.data import make_batch as jax_make_batch
from repro_torch import models as T
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_arrays
from repro_torch.data import make_batch

BF16 = dict(rtol=5e-2, atol=5e-2)
ATTN_ARCHS = ("olmo_1b", "gemma_7b", "phi3_medium_14b", "h2o_danube_1p8b",
              "paligemma_3b", "dbrx_132b", "qwen3_moe_235b_a22b")
CPU = torch.device("cpu")
B, S = 2, 16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module", params=ATTN_ARCHS)
def run(request):
    """Both packages through forward, prefill and decode_step on one arch."""
    arch = request.param
    cfg, jcfg = get_reduced(arch), jax_get_reduced(arch)
    jp = J.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_arrays(jax.tree.map(np.asarray, jp), device=CPU)
    batch = make_batch(cfg, B, S + 1, step=0)
    jbatch = jax_make_batch(jcfg, B, S + 1, step=0)
    assert all(np.array_equal(batch[k], jbatch[k]) for k in jbatch)
    toks = batch["tokens"]
    kw = {"frontend": batch["patches"]} if cfg.frontend_tokens else {}
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    pos = toks.shape[1] - 1 + cfg.frontend_tokens

    out = {"arch": arch, "cfg": cfg}
    out["forward"] = (T.forward(tp, cfg, toks, **kw),
                      J.forward(jp, jcfg, jnp.asarray(toks), **jkw))
    jc = J.init_cache(jcfg, B, S + 8)
    tc = T.init_cache(cfg, B, S + 8, device=CPU)
    jl, jc = J.prefill(jp, jcfg, jnp.asarray(toks[:, :-1]), jc, **jkw)
    tl, tc = T.prefill(tp, cfg, toks[:, :-1], tc, **kw)
    out["prefill"] = (tl, jl)
    # decode_step writes the port's caches in place: keep the prefill's
    out["caches"] = (jax.tree.map(lambda a: a.clone(), tc), jc)
    out["decode"] = (T.decode_step(tp, cfg, toks[:, -1:], tc, pos)[0],
                     J.decode_step(jp, jcfg, jnp.asarray(toks[:, -1:]), jc,
                                   jnp.int32(pos))[0])
    return out


def test_forward_equals_jax(run):
    got, want = run["forward"]
    cfg = run["cfg"]
    assert got.dtype == torch.bfloat16
    # make_batch's sequence holds the prefix: S + 1 positions in all
    assert got.shape == (B, S + 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_prefill_equals_jax(run):
    got, want = run["prefill"]
    assert got.shape == (B, 1, run["cfg"].vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    tc, jc = run["caches"]
    assert set(tc) == set(jc)
    for kind in jc:
        assert set(tc[kind]) == set(jc[kind]) == {"k", "v", "slot_pos"}
        for name in ("k", "v"):
            assert tc[kind][name].shape == jc[kind][name].shape
            assert tc[kind][name].dtype == torch.bfloat16
            np.testing.assert_allclose(_np(tc[kind][name]),
                                       _np(jc[kind][name]), **BF16)
        np.testing.assert_array_equal(tc[kind]["slot_pos"].numpy(),
                                      np.asarray(jc[kind]["slot_pos"]))


def test_decode_step_equals_jax(run):
    got, want = run["decode"]
    assert got.shape == (B, 1, run["cfg"].vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_decode_consistency(arch):
    """logits(prefill S tokens, then decode token S) == logits(forward over
    S+1 tokens)[:, -1] on the port alone, with its own weights; MoE archs at
    capacity factor 16, as the JAX package's test."""
    cfg = get_reduced(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = T.init_params(cfg, 1, device=CPU)
    batch = make_batch(cfg, B, S + 1, step=0)
    toks = batch["tokens"]
    kw = {"frontend": batch["patches"]} if cfg.frontend_tokens else {}
    full = T.forward(params, cfg, toks, **kw)
    caches = T.init_cache(cfg, B, S + 8, device=CPU)
    _, caches = T.prefill(params, cfg, toks[:, :-1], caches, **kw)
    pos = toks.shape[1] - 1 + cfg.frontend_tokens
    got, _ = T.decode_step(params, cfg, toks[:, -1:], caches, pos)
    np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, -1]), **BF16)


def test_whole_model_with_tcam_router_fails_as_the_reference():
    """The reference's layer loop passes no router bits to ``moe_ffn``
    (``repro/models/lm.py:194``), so a whole model with
    ``router="tcam_dt"`` fails the MoE layer's assertion; the port keeps
    that gap (ROADMAP Queue C)."""
    cfg = dataclasses.replace(get_reduced("qwen3_moe_235b_a22b"),
                              router="tcam_dt")
    jcfg = dataclasses.replace(jax_get_reduced("qwen3_moe_235b_a22b"),
                               router="tcam_dt")
    toks = make_batch(cfg, 1, 8)["tokens"]
    with pytest.raises(AssertionError, match="compiled bits"):
        J.forward(J.init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                  jnp.asarray(toks))
    with pytest.raises(AssertionError, match="compiled bits"):
        T.forward(T.init_params(cfg, 0, device=CPU), cfg, toks)
