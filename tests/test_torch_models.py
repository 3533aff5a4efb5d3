"""The port's model modules against the JAX package's on the same inputs,
made from a seed with numpy: the layers (norms, RoPE, the gated MLP with
SiLU and with tanh-GELU), chunked flash attention over
``test_models.py::test_flash_vs_naive``'s grid, decode attention over a ring
cache, the MoE layer (capacity, ranking within an expert, the chosen experts
and the output, in the three cases of ``test_models.py``), the TCAM router
(its compiled tensors and its routing, alone and inside the MoE layer), the
param tree of every attention-family config, and the configs that a later
slice brings.  The JAX package's weights are carried across by
``convert.lm_params_from_arrays``.

Tolerances, fixed before the comparison:

- f32 modules (norms, RoPE, MLP, attention, MoE outputs with f32 inputs,
  mamba's conv and mixer, the channel mix): ``rtol=atol=1e-5`` (another
  summation order; XLA's and PyTorch's ``exp`` and ``pow`` may differ by an
  ulp);
- rwkv's chunked mixer and one WKV chunk in f32: ``rtol=atol=1e-4``: the
  chunked form multiplies by factors up to e^{±44}, so an ulp of the
  cumulative log-decay (|L| up to 44) moves a factor by about 4e-6
  relative, and a product of two such factors by twice that;
- the recurrent mixers with bf16 inputs and weights cast to bf16:
  ``rtol=atol=5e-2`` (another rounding order of bf16 products);
- chunked against stepwise in the port alone: the JAX tests' own
  tolerances, mamba 2e-3 and rwkv 5e-3, the channel mix 1e-5;
- decode attention over a bf16 cache, whose output is rounded to bf16:
  ``rtol=atol=1e-2`` (a bf16 ulp near 1 is 2**-7);
- integers (capacities, ranks within an expert, chosen experts, routes,
  compiled router tensors, shapes, counts): exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import predict as jax_predict
from repro.core import train_tree as jax_train_tree
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mamba as JMB
from repro.models import moe as JM
from repro.models import params as JP
from repro.models import rwkv as JRW
from repro.models import tcam_router as JR
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch import obs
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core import predict, train_tree
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB
from repro_torch.models import moe as TM
from repro_torch.models import params as TP
from repro_torch.models import rwkv as TRW
from repro_torch.models import tcam_router as TR
from repro_torch.models.config import ModelConfig

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)
WKV_F32 = dict(rtol=1e-4, atol=1e-4)
MIX_BF16 = dict(rtol=5e-2, atol=5e-2)
ATTN_ARCHS = ("olmo_1b", "gemma_7b", "phi3_medium_14b", "h2o_danube_1p8b",
              "paligemma_3b", "dbrx_132b", "qwen3_moe_235b_a22b")
ARCHS = ATTN_ARCHS + ("jamba_v01_52b", "rwkv6_1p6b", "whisper_small")
CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# norms (zero-initialised scales) and mamba's zero-initialised conv bias
_SMALL = {"norm1", "norm2", "norm_x", "q_norm", "k_norm", "final_norm",
          "ln_x", "conv_b"}


def _draw(name: str, shape: tuple, rng) -> np.ndarray:
    """Seeded values for leaf ``name``, scaled about like its init."""
    if name == "A_log":
        return np.log(rng.uniform(0.5, shape[-1] + 1.0, shape))
    if name == "dt_b":      # softplus(dt_b) log-uniform on [1e-3, 1e-1]
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape))
        return np.log(np.expm1(dt))
    if name == "w_base":
        return rng.uniform(-6.0, 1.0, shape)
    if name in ("mu", "cm_mu"):
        return rng.uniform(0.0, 1.0, shape)
    n = rng.standard_normal(shape)
    if name in _SMALL:
        return 0.2 * n
    if name == "Dskip":
        return 1.0 + 0.5 * n
    if name == "u":
        return 0.5 * n
    if name in ("embed", "pos_emb", "dec_pos_emb"):
        return 0.02 * n
    # dense weights (w_lora_b too, zero at init): std 1/sqrt(fan_in)
    fan_in = shape[-1] if name == "conv_w" else shape[-2]
    return n / np.sqrt(fan_in)


def randomized(tree: dict, rng) -> dict:
    """The param tree (nested dicts, stacked or not) with every leaf
    replaced by f32 numpy draws from ``rng``, zero-initialised leaves
    included."""
    return {k: randomized(v, rng) if isinstance(v, dict)
            else _draw(k, np.shape(v), rng).astype(np.float32)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_norms_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3 + 0.5
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        _np(TL.rms_norm(_t(x), _t(scale), 1e-6)),
        _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)), **F32)
    np.testing.assert_allclose(
        _np(TL.nonparam_norm(_t(x), 1e-6)),
        _np(JL.nonparam_norm(jnp.asarray(x), 1e-6)), **F32)
    # bf16 in, bf16 out; the statistics are f32 on both sides
    xb = _t(x).to(torch.bfloat16)
    got = TL.rms_norm(xb, _t(scale), 1e-6)
    assert got.dtype == torch.bfloat16
    want = JL.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale),
                       1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_equals_jax(theta):
    rng = np.random.default_rng(1)
    pos = np.arange(40)
    s_t, c_t = TL.rope_table(_t(pos), 16, theta)
    s_j, c_j = JL.rope_table(jnp.asarray(pos), 16, theta)
    np.testing.assert_allclose(_np(s_t), _np(s_j), **F32)
    np.testing.assert_allclose(_np(c_t), _np(c_j), **F32)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.rope(_t(x), s_t, c_t)),
        _np(JL.rope(jnp.asarray(x), s_j, c_j)), **F32)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_equals_jax(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    p = {"w_gate": rng.standard_normal((16, 32)).astype(np.float32) * 0.3,
         "w_up": rng.standard_normal((16, 32)).astype(np.float32) * 0.3,
         "w_down": rng.standard_normal((32, 16)).astype(np.float32) * 0.3}
    got = TL.mlp(_t(x), {k: _t(v) for k, v in p.items()}, act)
    want = JL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                  act)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    if act == "gelu":
        # jax.nn.gelu's default is the tanh approximation, not erf
        g = _t(x) @ _t(p["w_gate"])
        exact = (torch.nn.functional.gelu(g) * (_t(x) @ _t(p["w_up"]))
                 @ _t(p["w_down"]))
        assert not np.allclose(_np(exact), _np(want), **F32)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,h,kv,causal,window,prefix", [
    (64, 4, 4, True, 0, 0),
    (64, 8, 2, True, 0, 0),       # GQA
    (128, 4, 1, True, 0, 0),      # MQA
    (64, 4, 2, True, 16, 0),      # SWA
    (64, 4, 4, False, 0, 0),      # encoder
    (64, 4, 2, True, 0, 24),      # paligemma prefix
])
def test_flash_attention_equals_jax(sq, h, kv, causal, window, prefix):
    rng = np.random.default_rng(sq + h)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, sq, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq, kv, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix, q_chunk=16,
              kv_chunk=32)
    got = TA.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # one chunk each (the defaults, which _fit cuts to the sequence)
    kw.pop("q_chunk"), kw.pop("kv_chunk")
    np.testing.assert_allclose(
        _np(TA.flash_attention(_t(q), _t(k), _t(v), **kw)),
        _np(JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)), **F32)


@pytest.mark.parametrize("dtype,window", [("float32", 0), ("float32", 8),
                                          ("bfloat16", 0), ("bfloat16", 8)])
def test_decode_attention_equals_jax(dtype, window):
    """A ring cache: some slots empty (-1), positions out of order."""
    rng = np.random.default_rng(3)
    S = 24
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    ck = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    slot_pos = np.full(S, -1, np.int32)
    slot_pos[:20] = (np.arange(20) + 12) % 20 + 10     # a wrapped ring
    pos = 29
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    got = TA.decode_attention(_t(q).to(tdt), _t(ck).to(tdt), _t(cv).to(tdt),
                              _t(slot_pos), pos, window=window)
    want = JA.decode_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(ck).astype(jdt),
        jnp.asarray(cv).astype(jdt), jnp.asarray(slot_pos), jnp.int32(pos),
        window=window)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_cfgs(groups=1, **kw):
    common = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                  n_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
                  pattern=("attn+moe",), n_experts=4, experts_per_token=2,
                  moe_d_ff=32, moe_groups=groups, capacity_factor=8.0)
    common.update(kw)
    return ModelConfig(**common), JaxModelConfig(**common)


@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 8.0, 16.0])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 4), (128, 8)])
def test_capacity_equals_jax(cf, e, k):
    cfg, jcfg = _moe_cfgs(capacity_factor=cf, n_experts=e,
                          experts_per_token=k)
    for t in range(1, 300):
        assert TM.capacity(cfg, t) == JM.capacity(jcfg, t), t
    for t in (2048, 16384, 32768):
        assert TM.capacity(cfg, t) == JM.capacity(jcfg, t), t


@pytest.mark.parametrize("n,e", [(1, 4), (16, 4), (64, 8), (1000, 128)])
def test_positions_in_expert_equal_jax(n, e):
    flat = np.random.default_rng(n).integers(0, e, n).astype(np.int32)
    got = TM._positions_in_expert(_t(flat).long(), e)
    want = JM._positions_in_expert(jnp.asarray(flat), e)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_block(cfg, key, kind="attn+moe"):
    return jax.tree.map(lambda a: a[0],
                        JP.init_params(cfg, jax.random.PRNGKey(key))
                        ["blocks"][kind])


def _jax_top(xt, w_router, k):
    gates = jax.nn.softmax(xt @ w_router, axis=-1)
    _, idx = jax.lax.top_k(gates, k)
    return np.asarray(idx)


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
@pytest.mark.parametrize("case", ["no_drops", "groups_2", "drops",
                                  "groups_4_drops"])
def test_moe_ffn_equals_jax(case, grad):
    """The three cases of ``test_models.py``: no drops (cf 8), two token
    groups, and capacity drops at cf 0.25; and four groups that overflow
    different experts at cf 0.25; f32 inputs.  With a gradient the groups
    run one at a time, without one (serving) side by side in one pass."""
    groups = {"groups_2": 2, "groups_4_drops": 4}.get(case, 1)
    drops = case in ("drops", "groups_4_drops")
    cf = 0.25 if drops else 8.0
    cfg, jcfg = _moe_cfgs(groups, capacity_factor=cf)
    jp = _jax_block(jcfg, {"no_drops": 3, "groups_2": 5, "drops": 7,
                           "groups_4_drops": 9}[case])
    tp = lm_params_from_arrays(_tree_np(jp), device=CPU)
    seq = 32 if drops else 8
    x = np.random.default_rng(4).standard_normal((2, seq, 16)).astype(
        np.float32)
    with torch.set_grad_enabled(grad):
        got = TM.moe_ffn(_t(x), tp, cfg)
    want = JM.moe_ffn(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(_np(got), _np(want), **F32)

    xt = x.reshape(-1, 16)
    _, top_i = TM.route(_t(xt), tp, cfg)
    jtop = _jax_top(jnp.asarray(xt), jp["w_router"], 2)
    np.testing.assert_array_equal(top_i.numpy(), jtop)
    # ranks within an expert, per group, and so the tokens dropped
    c = TM.capacity(cfg, x.shape[0] * x.shape[1] // groups)
    over = []
    for grp_t, grp_j in zip(top_i.reshape(groups, -1),
                            jtop.reshape(groups, -1)):
        pos = TM._positions_in_expert(grp_t, 4)
        np.testing.assert_array_equal(
            pos.numpy(),
            np.asarray(JM._positions_in_expert(jnp.asarray(grp_j), 4)))
        over.append(frozenset(grp_t[pos >= c].tolist()))
    if drops:
        assert any(over)
    if case == "groups_4_drops":      # not every group overflows alike
        assert len(set(over)) > 1


def _moe_counted(x, tp, cfg, grad: bool):
    """``moe_ffn`` with or without a gradient: (output, counters)."""
    obs.reset()
    obs.enable(True)
    try:
        with torch.set_grad_enabled(grad):
            y = TM.moe_ffn(x, tp, cfg)
        return y.detach(), obs.counters()
    finally:
        obs.enable(False)
        obs.reset()


@pytest.mark.parametrize("groups,cf", [(2, 0.25), (4, 0.25), (8, 8.0)])
def test_moe_serving_pass_keeps_the_per_group_dispatches(groups, cf):
    """The serving pass (groups side by side) keeps and drops the same
    dispatches as one pass a group, into as many expert rows, and gives the
    same output."""
    cfg, jcfg = _moe_cfgs(groups, capacity_factor=cf)
    tp = lm_params_from_arrays(_tree_np(_jax_block(jcfg, 11)), device=CPU)
    x = _t(np.random.default_rng(12).standard_normal((2, 32, 16)).astype(
        np.float32))
    y_one, per_group = _moe_counted(x, tp, cfg, grad=True)
    y_all, side = _moe_counted(x, tp, cfg, grad=False)
    for name in ("moe.kept", "moe.slots", "moe.dispatched"):
        assert side[name] == per_group[name], name
    if cf < 1:
        assert side["moe.kept"] < side["moe.dispatched"]
    np.testing.assert_allclose(_np(y_all), _np(y_one), **F32)


@pytest.mark.parametrize("groups", [1, 2, 8])
@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
def test_moe_pass_counters(groups, grad):
    """Without a gradient one expert pass computes every group; with one,
    each group is a pass of its own."""
    cfg, jcfg = _moe_cfgs(groups)
    tp = lm_params_from_arrays(_tree_np(_jax_block(jcfg, 5)), device=CPU)
    x = _t(np.random.default_rng(6).standard_normal((2, 8, 16)).astype(
        np.float32))
    _, got = _moe_counted(x, tp, cfg, grad)
    want = (1, groups) if not grad else (groups, groups)
    assert (got["moe.passes"], got["moe.pass_groups"]) == want


def test_moe_groups_invariant_and_dense_reference():
    """As ``test_models.py``: with no drops the token groups change nothing,
    and the layer equals the explicit per-expert dense computation."""
    cfg1, jcfg = _moe_cfgs(1)
    cfg2, _ = _moe_cfgs(2)
    tp = lm_params_from_arrays(_tree_np(_jax_block(jcfg, 5)), device=CPU)
    x = _t(np.random.default_rng(6).standard_normal((2, 8, 16)).astype(
        np.float32))
    y1 = TM.moe_ffn(x, tp, cfg1)
    np.testing.assert_allclose(_np(y1), _np(TM.moe_ffn(x, tp, cfg2)), **F32)
    xt = x.reshape(-1, 16)
    w, idx = torch.topk(torch.softmax(xt @ tp["w_router"], -1), 2)
    w = w / w.sum(-1, keepdim=True)
    dense = torch.stack([
        (torch.nn.functional.silu(xt @ tp["w_gate"][e]) * (xt @ tp["w_up"][e]))
        @ tp["w_down"][e] for e in range(4)], 1)
    want = torch.einsum("tk,tkd->td", w,
                        torch.take_along_dim(dense, idx[..., None], 1))
    np.testing.assert_allclose(_np(y1.reshape(-1, 16)), _np(want), **F32)


# ---------------------------------------------------------------------------
# TCAM router
# ---------------------------------------------------------------------------
def _trees(X, y, **kw):
    jt, tt = jax_train_tree(X, y, **kw), train_tree(X, y, **kw)
    for f in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    return jt, tt


def _router_equal(jbits, tbits):
    assert set(jbits) == set(tbits)
    for name, arr in jbits.items():
        got = tbits[name]
        assert got.device == CPU and got.shape == arr.shape, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(arr), name)
    assert tbits["bit_thr"].dtype == torch.float32


def test_router_matches_tree_and_jax():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((500, 8))
    y = ((X[:, 0] > 0) * 2 + (X[:, 1] > 0.5)).astype(np.int64)   # 4 experts
    jt, tt = _trees(X, y, max_depth=6)
    jbits, tbits = JR.compile_router(jt), TR.compile_router(tt, device=CPU)
    _router_equal(jbits, tbits)
    Xt = rng.standard_normal((200, 8))
    got = TR.route_tcam(_t(Xt).float(), tbits).numpy()
    np.testing.assert_array_equal(got, predict(tt, Xt))
    np.testing.assert_array_equal(
        got, np.asarray(JR.route_tcam(jnp.asarray(Xt, jnp.float32), jbits)))
    np.testing.assert_array_equal(got, jax_predict(jt, Xt))


def test_router_in_moe_layer_equals_jax():
    cfg, jcfg = _moe_cfgs(d_model=8, head_dim=4, d_ff=16, vocab_size=32,
                          moe_d_ff=16, router="tcam_dt")
    jp = jax.tree.map(lambda a: a[0], JP.init_params(
        jcfg, jax.random.PRNGKey(0))["blocks"]["attn+moe"])
    tp = lm_params_from_arrays(_tree_np(jp), device=CPU)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((400, 8))
    yexp = (X[:, 0] > 0).astype(np.int64) * 3   # experts 0 / 3
    jt, tt = _trees(X, yexp, max_depth=4)
    jbits, tbits = JR.compile_router(jt), TR.compile_router(tt, device=CPU)
    _router_equal(jbits, tbits)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    got = TM.moe_ffn(_t(x), tp, cfg, router_bits=tbits)
    want = JM.moe_ffn(jnp.asarray(x), jp, jcfg, router_bits=jbits)
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    top_w, top_i = TM.route(_t(x).reshape(-1, 8), tp, cfg, tbits)
    assert top_i.shape == (32, 1) and bool((top_w == 1).all())
    np.testing.assert_array_equal(top_i[:, 0].numpy(),
                                  predict(tt, x.reshape(-1, 8)))
    with pytest.raises(AssertionError, match="compiled bits"):
        TM.moe_ffn(_t(x), tp, cfg)


# ---------------------------------------------------------------------------
# recurrent mixers: mamba, rwkv and the channel mix
# ---------------------------------------------------------------------------
def _mix_cfgs(kind):
    """One layer of the reduced jamba (mamba) or rwkv6 config."""
    arch = "jamba_v01_52b" if kind == "mamba+mlp" else "rwkv6_1p6b"
    return get_reduced(arch), jax_get_reduced(arch)


def _mix_block(kind, seed):
    """One layer's randomized leaves: (numpy, JAX, port)."""
    _, jcfg = _mix_cfgs(kind)
    jp = jax.tree.map(lambda a: np.asarray(a[0]),
                      JP.init_params(jcfg, jax.random.PRNGKey(0))
                      ["blocks"][kind])
    leaves = randomized(jp, np.random.default_rng(seed))
    return (leaves, jax.tree.map(jnp.asarray, leaves),
            lm_params_from_arrays(leaves, device=CPU))


DTYPES = {"float32": (torch.float32, jnp.float32, F32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, MIX_BF16)}


def _pair(a: np.ndarray, dtype: str):
    tdt, jdt, _ = DTYPES[dtype]
    return _t(a).to(tdt), jnp.asarray(a).astype(jdt)


def _close(got, want, tol):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_prev", [False, True])
def test_conv_causal_equals_jax(dtype, with_prev):
    """The depthwise causal conv accumulates in f32 and returns the input's
    dtype, with and without the carried K-1 inputs."""
    rng = np.random.default_rng(10)
    x, xj = _pair(rng.standard_normal((2, 9, 24)).astype(np.float32), dtype)
    w = rng.standard_normal((24, 4)).astype(np.float32) * 0.5
    b = rng.standard_normal(24).astype(np.float32) * 0.2
    prev = prevj = None
    if with_prev:
        prev, prevj = _pair(rng.standard_normal((2, 3, 24)).astype(
            np.float32), dtype)
    got = TMB._conv_causal(x, _t(w), _t(b), prev)
    want = JMB._conv_causal(xj, jnp.asarray(w), jnp.asarray(b), prevj)
    assert got.dtype == x.dtype
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_mixer_equals_jax(dtype, with_state):
    """mamba_mixer at the reduced jamba width on randomized leaves; with a
    carried (conv, h) state it also returns the new state."""
    cfg, jcfg = _mix_cfgs("mamba+mlp")
    _, jp, tp = _mix_block("mamba+mlp", 11)
    rng = np.random.default_rng(12)
    x, xj = _pair(rng.standard_normal((2, 12, cfg.d_model)).astype(
        np.float32), dtype)
    if not with_state:
        got = TMB.mamba_mixer(x, tp, cfg)
        want = JMB.mamba_mixer(xj, jp, jcfg)
        assert got.dtype == x.dtype
        _close(got, want, DTYPES[dtype][2])
        return
    conv, convj = _pair(rng.standard_normal(
        (2, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32), dtype)
    h0 = rng.standard_normal((2, cfg.d_inner, cfg.ssm_state)).astype(
        np.float32) * 0.3
    got = TMB.mamba_mixer(x, tp, cfg, state=(conv, _t(h0)),
                          return_state=True)
    want = JMB.mamba_mixer(xj, jp, jcfg, state=(convj, jnp.asarray(h0)),
                           return_state=True)
    assert got[1][0].dtype == x.dtype and got[1][1].dtype == torch.float32
    _close(got[0], want[0], DTYPES[dtype][2])
    _close(got[1][0], want[1][0], DTYPES[dtype][2])
    # the SSM state is f32 on both sides; from bf16 inputs it inherits
    # their rounding, so it is held at the dtype's tolerance
    _close(got[1][1], want[1][1], DTYPES[dtype][2])


@pytest.mark.parametrize("c", [16, 7])
def test_wkv_chunk_equals_jax(c):
    """One chunk with a decay whose cumulative log reaches the CLIP range."""
    rng = np.random.default_rng(13)
    h, hd = 2, 8
    r, k, v = (rng.standard_normal((2, h, c, hd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-8.0, 1.0, (2, h, c, hd))).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32) * 0.5
    s_in = rng.standard_normal((2, h, hd, hd)).astype(np.float32)
    got = TRW._wkv_chunk(*map(_t, (s_in, r, k, v, logw, u)))
    want = JRW._wkv_chunk(*map(jnp.asarray, (s_in, r, k, v, logw, u)))
    _close(got, want, WKV_F32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_mixer_equals_jax(dtype, with_state):
    """rwkv_mixer at the reduced rwkv6 width over 40 tokens (chunks of 8)
    on randomized leaves, with and without a carried (x_prev, S) state;
    f32 at the WKV tolerance (see the module docstring)."""
    cfg, jcfg = _mix_cfgs("rwkv+cmix")
    _, jp, tp = _mix_block("rwkv+cmix", 14)
    rng = np.random.default_rng(15)
    x, xj = _pair(rng.standard_normal((2, 40, cfg.d_model)).astype(
        np.float32), dtype)
    tol = WKV_F32 if dtype == "float32" else MIX_BF16
    if not with_state:
        got = TRW.rwkv_mixer(x, tp, cfg)
        want = JRW.rwkv_mixer(xj, jp, jcfg)
        assert got.dtype == x.dtype
        _close(got, want, tol)
        return
    xa, xaj = _pair(rng.standard_normal((2, cfg.d_model)).astype(
        np.float32), dtype)
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    s0 = rng.standard_normal((2, h, hd, hd)).astype(np.float32)
    got = TRW.rwkv_mixer(x, tp, cfg, state=(xa, _t(s0)), return_state=True)
    want = JRW.rwkv_mixer(xj, jp, jcfg, state=(xaj, jnp.asarray(s0)),
                          return_state=True)
    assert got[1][1].dtype == torch.float32
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_channel_mix_equals_jax(dtype, with_state):
    cfg, jcfg = _mix_cfgs("rwkv+cmix")
    _, jp, tp = _mix_block("rwkv+cmix", 16)
    rng = np.random.default_rng(17)
    x, xj = _pair(rng.standard_normal((2, 9, cfg.d_model)).astype(
        np.float32), dtype)
    tol = DTYPES[dtype][2]
    if not with_state:
        got = TRW.rwkv_channel_mix(x, tp, cfg)
        _close(got, JRW.rwkv_channel_mix(xj, jp, jcfg), tol)
        return
    xc, xcj = _pair(rng.standard_normal((2, cfg.d_model)).astype(
        np.float32), dtype)
    got = TRW.rwkv_channel_mix(x, tp, cfg, state=xc, return_state=True)
    want = JRW.rwkv_channel_mix(xj, jp, jcfg, state=xcj, return_state=True)
    _close(got, want, tol)


def _small_mix_cfg(kind):
    """``test_models.py``'s one-layer configs of the stepwise checks."""
    if kind == "mamba+mlp":
        return ModelConfig(name="t", family="ssm", n_layers=1, d_model=32,
                           n_heads=4, n_kv_heads=4, head_dim=8, d_ff=64,
                           vocab_size=64, pattern=(kind,), ssm_state=4)
    return ModelConfig(name="t", family="ssm", n_layers=1, d_model=32,
                       n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                       vocab_size=64, pattern=(kind,), rwkv_head_dim=16,
                       rope_theta=0.0)


def _small_block(cfg, seed):
    p = {k: v[0] for k, v in TP.init_params(
        cfg, seed, device=CPU)["blocks"][cfg.pattern[0]].items()}
    return lm_params_from_arrays(
        randomized({k: v.numpy() for k, v in p.items()},
                   np.random.default_rng(seed)), device=CPU)


def _stepwise(mixer, x, p, cfg, state):
    outs = []
    for t in range(x.shape[1]):
        o, state = mixer(x[:, t:t + 1], p, cfg, state=state,
                         return_state=True)
        outs.append(o)
    return torch.cat(outs, dim=1), state


@pytest.mark.parametrize("s", [2 * TMB.CHUNK, 263])
def test_mamba_chunked_equals_stepwise(s):
    """The chunked selective scan (chunks of 256, or of 1 at a prime
    length) equals the token-by-token recurrence, state included."""
    cfg = _small_mix_cfg("mamba+mlp")
    p = _small_block(cfg, 0)
    x = _t(np.random.default_rng(0).standard_normal((2, s, 32)).astype(
        np.float32))
    full, (conv, h) = TMB.mamba_mixer(x, p, cfg, return_state=True)
    step, (conv_s, h_s) = _stepwise(
        TMB.mamba_mixer, x, p, cfg, TMB.init_mamba_state(cfg, 2, torch.float32,
                                                         device=CPU))
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(full), _np(step), **tol)
    np.testing.assert_allclose(_np(h), _np(h_s), **tol)
    # the last K-1 projected inputs (one product over S rows, or S of one)
    np.testing.assert_allclose(_np(conv), _np(conv_s), **tol)


@pytest.mark.parametrize("s", [2 * TRW.CHUNK, 37])
def test_rwkv_chunked_equals_stepwise(s):
    cfg = _small_mix_cfg("rwkv+cmix")
    p = _small_block(cfg, 1)
    x = _t(0.5 * np.random.default_rng(1).standard_normal((2, s, 32)).astype(
        np.float32))
    full, (xa, sst) = TRW.rwkv_mixer(x, p, cfg, return_state=True)
    xa0, s0, _ = TRW.init_rwkv_state(cfg, 2, torch.float32, device=CPU)
    step, (xa_s, sst_s) = _stepwise(TRW.rwkv_mixer, x, p, cfg, (xa0, s0))
    tol = dict(rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(_np(full), _np(step), **tol)
    np.testing.assert_allclose(_np(sst), _np(sst_s), **tol)
    assert torch.equal(xa, xa_s)


def test_rwkv_channel_mix_stepwise():
    cfg = _small_mix_cfg("rwkv+cmix")
    p = _small_block(cfg, 2)
    x = _t(np.random.default_rng(2).standard_normal((2, 8, 32)).astype(
        np.float32))
    full = TRW.rwkv_channel_mix(x, p, cfg)
    step, _ = _stepwise(TRW.rwkv_channel_mix, x, p, cfg,
                        torch.zeros((2, 32)))
    np.testing.assert_allclose(_np(full), _np(step), **F32)


# ---------------------------------------------------------------------------
# params and configs
# ---------------------------------------------------------------------------
def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_equals_jax(arch):
    cfg, jcfg = get_reduced(arch), jax_get_reduced(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tp = TP.init_params(cfg, 0, device=CPU)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    assert _shapes(tp) == _shapes(jp)
    assert all(leaf.dtype == torch.float32 and leaf.device == CPU
               for leaf in jax.tree.leaves(tp))
    assert TP.param_count(tp) == JP.param_count(jp)
    assert TP.param_logical_axes(cfg) == JP.param_logical_axes(jcfg)
    # the same seed gives the same weights; norms start at zero
    again = TP.init_params(cfg, 0, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(tp),
                                                 jax.tree.leaves(again)))
    assert not torch.equal(tp["embed"], TP.init_params(cfg, 1,
                                                       device=CPU)["embed"])
    assert float(tp["final_norm"].abs().max()) == 0.0
    # the deterministic inits are the JAX package's; dt_b's softplus lies
    # in [1e-3, 1e-1]
    for kind, leaves in jp["blocks"].items():
        for name in ("A_log", "w_base", "mu", "cm_mu", "Dskip"):
            if name in leaves:
                np.testing.assert_allclose(tp["blocks"][kind][name].numpy(),
                                           np.asarray(leaves[name]), **F32)
        if "dt_b" in leaves:
            dt = torch.nn.functional.softplus(tp["blocks"][kind]["dt_b"])
            assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
            assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    if cfg.is_encdec:
        assert TP.kind_specs(cfg, "attn+mlp", with_cross=True).keys() > {
            "norm_x", "xwq", "xwk", "xwv", "xwo"}
        assert float(tp["encoder"]["final_norm"].abs().max()) == 0.0


def test_lm_params_from_arrays_keeps_values_dtypes_and_layout():
    rng = np.random.default_rng(9)
    w = rng.standard_normal((3, 4, 5)).astype(np.float32)
    tree = {"a": w, "b": {"c": np.asarray(jnp.asarray(w).astype(jnp.bfloat16)),
                          "d": np.arange(6, dtype=np.int32)}}
    got = lm_params_from_arrays(tree, device=CPU)
    assert got["a"].dtype == torch.float32 and got["a"].shape == (3, 4, 5)
    np.testing.assert_array_equal(got["a"].numpy(), w)
    assert got["b"]["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"]["c"].float().numpy(),
                                  tree["b"]["c"].astype(np.float32))
    assert got["b"]["d"].dtype == torch.int32
    np.testing.assert_array_equal(got["b"]["d"].numpy(), np.arange(6))
