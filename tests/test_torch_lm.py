"""The port's LM serving path against the JAX package's: ``forward``,
``prefill`` (last logits and every cache leaf) and ``decode_step`` for the
``reduced()`` config of each of the ten archs, with the JAX package's
weights carried across by ``lm_params_from_arrays``, the same tokens (and
paligemma's prefix patches, whisper's frames) from ``make_batch``; then the
port's own prefill -> decode consistency with its full forward for all ten,
as ``test_archs_smoke.py::test_prefill_decode_consistency`` holds the JAX
package's.

The seven attention-family archs run at their init weights in bf16.
Tolerances, fixed before the comparison: logits and cache entries are bf16
and compared at ``rtol=atol=5e-2``, the JAX package's own tolerance for its
prefill/decode test (the two libraries accumulate the bf16 products in
another order and round elementwise chains at other points, so values a few
bf16 ulps apart are expected); ``slot_pos`` and the cache shapes and dtypes
are exact.  h2o-danube's reduced window (16) is shorter than the cache
(24), so its decode step wraps the ring.

The recurrent and encoder-decoder archs (jamba, rwkv6, whisper) run on
randomized leaves (``test_torch_models.randomized``: every leaf drawn from
a seed and scaled about like its init, zero-initialised ones included), in
f32 compute and in bf16 as served:

- f32 compute (the compute dtype and the caches f32 in both packages):
  logits and every float cache leaf at ``rtol=atol=1e-4`` (eight layers of
  f32 products in another summation order, and rwkv's e^{±44} factors);
  this is the check that every term of every mixer is the reference's;
- bf16 as served: on the reduced jamba and rwkv6 the JAX package's own
  bf16 logits lie up to 0.2-0.8 from its f32 ones, since each recurrent
  layer amplifies the last-ulp differences of the one before (and a MoE
  gate can flip), and XLA rounds every op of a bf16 ``sigmoid`` where
  PyTorch rounds once.  So each bf16 output of the port (logits and every
  float cache leaf) is held to the reference's own rounding band: its
  largest distance from the reference's f32 result is at most twice the
  largest distance of the reference's bf16 result from it.  Whisper is
  also held to 5e-2 against the reference's bf16, as the attention
  families are.  Shapes, dtypes and ``slot_pos`` are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unittest import mock

from repro import models as J
from repro.models import lm as JLM
from repro.configs import get_reduced as jax_get_reduced
from repro.data import make_batch as jax_make_batch
from repro_torch import models as T
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_arrays
from repro_torch.data import make_batch
from repro_torch.models import lm as TLM
from test_torch_models import randomized

BF16 = dict(rtol=5e-2, atol=5e-2)
F32 = dict(rtol=1e-4, atol=1e-4)
ATTN_ARCHS = ("olmo_1b", "gemma_7b", "phi3_medium_14b", "h2o_danube_1p8b",
              "paligemma_3b", "dbrx_132b", "qwen3_moe_235b_a22b")
NEW_ARCHS = ("jamba_v01_52b", "rwkv6_1p6b", "whisper_small")
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


def _inputs(cfg, batch):
    if cfg.frontend_tokens:
        return {"frontend": batch["patches"]}
    if cfg.is_encdec:
        return {"frames": batch["frames"]}
    return {}


def _both(arch, tp, jp, tdt, jdt):
    """forward, prefill (logits and a copy of every cache leaf) and
    decode_step of both packages with ``tdt``/``jdt`` as compute dtype."""
    cfg, jcfg = get_reduced(arch), jax_get_reduced(arch)
    batch = make_batch(cfg, B, S + 1, step=0)
    toks, kw = batch["tokens"], _inputs(cfg, batch)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    out = {}
    with mock.patch.object(TLM, "COMPUTE_DTYPE", tdt), \
            mock.patch.object(JLM, "COMPUTE_DTYPE", jdt):
        out["forward"] = (T.forward(tp, cfg, toks, **kw),
                          J.forward(jp, jcfg, jnp.asarray(toks), **jkw))
        jc = J.init_cache(jcfg, B, S + 8, dtype=jdt)
        tc = T.init_cache(cfg, B, S + 8, dtype=tdt, device=CPU)
        jl, jc = J.prefill(jp, jcfg, jnp.asarray(toks[:, :-1]), jc, **jkw)
        tl, tc = T.prefill(tp, cfg, toks[:, :-1], tc, **kw)
        out["prefill"] = (tl, jl)
        out["caches"] = (jax.tree.map(lambda a: a.clone(), tc), jc)
        out["decode"] = (
            T.decode_step(tp, cfg, toks[:, -1:], tc, S)[0],
            J.decode_step(jp, jcfg, jnp.asarray(toks[:, -1:]), jc,
                          jnp.int32(S))[0])
    return out


@pytest.fixture(scope="module", params=NEW_ARCHS)
def recurrent(request):
    """Both packages on randomized leaves, in f32 compute and in bf16."""
    arch = request.param
    jcfg = jax_get_reduced(arch)
    leaves = randomized(jax.tree.map(np.asarray, J.init_params(
        jcfg, jax.random.PRNGKey(0))), np.random.default_rng(7))
    jp = jax.tree.map(jnp.asarray, leaves)
    tp = lm_params_from_arrays(leaves, device=CPU)
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    return {"arch": arch, "cfg": get_reduced(arch),
            "float32": _both(arch, tp, jp, torch.float32, jnp.float32),
            "bfloat16": _both(arch, tp, jp, torch.bfloat16, jnp.bfloat16)}


def _held(run, stage, dtype):
    """(port, reference) pairs of ``stage``: the logits, or every float
    cache leaf; returns also the reference's f32 counterparts."""
    if stage != "caches":
        return [(run[dtype][stage], run["float32"][stage][1])]
    tc, jc = run[dtype]["caches"]
    assert set(tc) == set(jc)
    pairs = []
    for kind in jc:
        assert set(tc[kind]) == set(jc[kind])
        for name, want in jc[kind].items():
            got = tc[kind][name]
            assert got.shape == want.shape
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            if name == "slot_pos":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                pairs.append(((got, want),
                              run["float32"]["caches"][1][kind][name]))
    return pairs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage", ["forward", "prefill", "caches", "decode"])
def test_recurrent_and_encdec_equal_jax(recurrent, stage, dtype):
    """jamba, rwkv6 and whisper: forward, prefill's last logits, every
    cache leaf after prefill, and decode_step, at the tolerances of the
    module docstring."""
    cfg = recurrent["cfg"]
    pairs = _held(recurrent, stage, dtype)
    assert pairs
    for (got, want), ref32 in pairs:
        if stage != "caches":
            assert got.shape[-1] == cfg.vocab_size
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), **F32)
            continue
        band = np.abs(_np(want) - _np(ref32)).max()
        err = np.abs(_np(got) - _np(ref32)).max()
        assert err <= 2 * band, (err, band)
        if recurrent["arch"] == "whisper_small":
            np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_encoder_tree_carried_across():
    """``lm_params_from_arrays`` carries whisper's encoder subtree and the
    decoder's positional table, leaf for leaf."""
    jcfg = jax_get_reduced("whisper_small")
    jp = jax.tree.map(np.asarray, J.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = lm_params_from_arrays(jp, device=CPU)
    assert set(tp["encoder"]) == {"blocks", "final_norm", "pos_emb"}
    assert tp["dec_pos_emb"].shape == (32768, jcfg.d_model)
    for got, want in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ATTN_ARCHS + NEW_ARCHS)
def test_prefill_decode_consistency(arch):
    """logits(prefill S tokens, then decode token S) == logits(forward over
    S+1 tokens)[:, -1] on the port alone, with its own weights; MoE archs at
    capacity factor 16, as the JAX package's test."""
    cfg = get_reduced(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = T.init_params(cfg, 1, device=CPU)
    batch = make_batch(cfg, B, S + 1, step=0)
    toks, kw = batch["tokens"], _inputs(cfg, batch)
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
