"""Sharded serving over a ("data", "model") ``DeviceMesh`` on ``gloo`` ranks
on the CPU: ``build_prefill_step``/``build_decode_step`` with the default
serving rules (``make_rules(mesh)``), against the JAX package's
``prefill``/``decode_step`` with ``rules=None`` and against the port's
unsharded path.

One spawn per mesh (``torch_ranks.spawn``, one torch thread a rank); each
runs every case and the tests read the results.  The meshes:

- (1, 1): the sharded path equals the unsharded one bit for bit, and
  ``shard_params`` copies nothing;
- (2, 1): data-parallel serving, the weights gathered at use over
  "data" (jamba's two MoE groups split over it);
- (1, 2): heads, kv heads, ``mlp``, experts and vocab split in two, and
  jamba's mamba inner dim, rwkv6's heads (its WKV state gathered back
  whole) and whisper's cross-attention heads;
- (2, 2): the MoE groups split over "data" in prefill, while a decode
  batch of 4 is one token group (``g = 1``) that spans both data ranks;
- (1, 4): qwen3's and phi3's two kv heads do not divide 4, so their
  caches split ``head_dim`` (decode sums the partial scores over "model");
  paligemma's one kv head likewise;
- (1, 3): no dim of the reduced configs divides 3, so everything is
  replicated.

Every mesh serves all ten configurations.

The reduced configs, ``make_batch`` tokens (paligemma's patches,
whisper's frames): a prefill of 4 x 16 text tokens, then 4 decode steps on
fixed tokens (the batch's next ones, not greedy, so a tie cannot change
the path).  The attention families run at the JAX package's init weights;
jamba, rwkv6 and whisper on randomized leaves
(``test_torch_models.randomized``), as in ``test_torch_lm.py``.

What is held, each rank's gathered logits (prefill and every decode step)
and every cache leaf (after prefill and after the last step), fixed before
the first run:

- against the JAX package in f32 compute (``COMPUTE_DTYPE`` patched in
  each rank) at ``rtol=atol=1e-4``, with every token of every MoE layer
  routed to the experts the JAX package picks (recorded from its
  ``jax.lax.top_k``) and the port's unsharded path picks;
- against the JAX package in bf16 at 5e-2.  At 4 x 16 tokens and 4 steps
  a near tie of two gates falls on the other side in one package's bf16
  and not in the other's, in the unsharded paths already (dbrx's port,
  qwen3's reference), and one flipped expert moves the outputs by up to
  1.7; so every bf16 run of the port (sharded and unsharded) takes the
  JAX package's bf16 expert choices, weighted by its own gates (as
  ``chip_smoke.py``'s ``lm_consistency`` replays ``forward``'s).  jamba's
  and rwkv6's bf16 lie further than 5e-2 from the JAX package's in the
  unsharded paths too (``test_torch_lm.py`` holds them to the reference's
  rounding band, which 4 x 16 tokens also exceed), so they are held in
  bf16 against the port's unsharded bf16 only, jamba's sharded runs taking
  the unsharded run's experts;
- against the port's unsharded path: f32 at ``rtol=atol=1e-5``, bf16 at
  5e-2 (on the mesh of one bit for bit, in both dtypes);
- qwen3's first MoE layer alone, at capacity factor 0.5 so that it drops
  dispatches, on 4 x 48 tokens in 1, 3 or 4 token groups (one group
  spanning the data ranks, groups split between them, whole groups per
  rank): each rank's rows equal the unsharded layer's within 1e-5 (the
  prefill and decode above drop nothing at these sizes, so they cannot
  tell a rank's own capacity from the global batch's);
- each rank's param and cache shards have the local shapes of
  ``input_specs``' specs on that mesh;
- on a "model" axis larger than 1 the train step runs too (reduced
  olmo-1b, one step in f32 compute): its loss within 1e-6 and its
  gradient norm within 1e-5 (relative) of the unsharded port's step with
  the same one microbatch (``test_torch_tp_train.py`` holds the step leaf
  by leaf).

The spawns run in a thread while the parent makes the JAX references
(about 100 s in all on one worker).
"""
import concurrent.futures
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import make_batch
from repro_torch.pytree import tree_map
from torch_ranks import spawn

# the spawned ranks import this module: JAX is imported only where the
# parent uses it

ATTN = ("olmo_1b", "gemma_7b", "h2o_danube_1p8b", "phi3_medium_14b",
        "paligemma_3b", "qwen3_moe_235b_a22b", "dbrx_132b")
RECURRENT = ("jamba_v01_52b", "rwkv6_1p6b", "whisper_small")
MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (1, 3))
ARCHS = ATTN + RECURRENT
DTYPES = ("float32", "bfloat16")
B, S, STEPS = 4, 16, 4
MOE, MOE_SEQ, MOE_GROUPS = "qwen3_moe_235b_a22b", 48, (1, 3, 4)
F32_JAX = dict(rtol=1e-4, atol=1e-4)
F32_PORT = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _leaves(arch) -> dict:
    """The JAX package's init params (randomized for the recurrent and
    encoder-decoder archs) as numpy arrays."""
    import jax

    from repro import models as J
    from repro.configs import get_reduced as jax_get_reduced
    from test_torch_models import randomized
    jp = jax.tree.map(np.asarray, J.init_params(jax_get_reduced(arch),
                                                jax.random.PRNGKey(0)))
    return randomized(jp, np.random.default_rng(7)) if arch in RECURRENT \
        else jp


def _inputs(cfg):
    """The tokens (B, S + STEPS) and the prefix patches or frames."""
    batch = make_batch(cfg, B, S + STEPS + cfg.frontend_tokens, step=0)
    extra = {k: batch[k] for k in ("patches", "frames") if k in batch}
    return batch["tokens"], extra


def _max_seq(cfg) -> int:
    return S + STEPS + cfg.frontend_tokens


# -- the port, unsharded here or sharded in a rank ------------------------------
def _whole(t):
    """A copy of the whole of ``t`` (a ``DTensor``'s ``full_tensor`` may be
    its local tensor, which later steps write in place)."""
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).clone()


def _port_run(arch, leaves, dtype, rules=None, replay=None) -> dict:
    """Prefill then ``STEPS`` decode steps through the port's step builders
    (sharded with ``rules``): the whole logits of each stage, the whole
    caches after prefill and after the last step, and per stage the expert
    choices of this rank's tokens, (MoE layers, tokens, k).  With
    ``replay`` (per stage the reference's choices for every token, (MoE
    layers, tokens, k)) the MoE layers take those experts, weighted by
    their own gates."""
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models import init_cache, moe
    from repro_torch.models import lm as TLM
    from repro_torch.train import build_decode_step, build_prefill_step
    cfg = get_reduced(arch)
    toks, extra = _inputs(cfg)
    tdt = getattr(torch, dtype)
    params = lm_params_from_arrays(leaves, device="cpu", cfg=cfg,
                                   rules=rules)
    caches = init_cache(cfg, B, _max_seq(cfg), dtype=tdt, device="cpu",
                        rules=rules)
    prefill = build_prefill_step(cfg, rules)
    decode = build_decode_step(cfg, rules)
    route, calls, queue = moe.route, [], []
    lo, hi = (0, B) if rules is None else _rows(rules)

    def recording(xt, p, cfg, router_bits=None, *, shards=None):
        if replay is None:
            out = route(xt, p, cfg, router_bits, shards=shards)
        else:
            out = _replayed(xt, p, cfg, shards, queue)
        calls.append(out[1])
        return out

    def stage_queue(stage):
        # this rank's tokens, layer by layer, as the layers' calls take them
        if replay is not None and replay[stage] is not None:
            r = replay[stage]
            s = r.shape[1] // B
            queue[:] = [torch.as_tensor(r[:, lo * s:hi * s]).reshape(
                -1, r.shape[2])]

    def stage_routes():
        n = sum(k.endswith("+moe") for k in cfg.pattern) * cfg.n_repeat
        got = (torch.cat(calls).reshape(n, -1, cfg.experts_per_token)
               if n else None)
        calls.clear()
        return got

    out = {"logits": [], "routes": []}
    with mock.patch.object(TLM, "COMPUTE_DTYPE", tdt), \
            mock.patch.object(moe, "route", recording):
        stage_queue(0)
        logits, caches = prefill(params, {"tokens": toks[:, :S], **extra},
                                 caches)
        out["logits"].append(_whole(logits))
        out["routes"].append(stage_routes())
        out["prefill_caches"] = tree_map(_whole, caches)
        for i in range(STEPS):
            stage_queue(i + 1)
            logits, caches = decode(params, toks[:, S + i:S + i + 1], caches,
                                    S + i + cfg.frontend_tokens)
            out["logits"].append(_whole(logits))
            out["routes"].append(stage_routes())
    assert not queue or not len(queue[0]), "every replayed choice taken"
    out["caches"] = tree_map(_whole, caches)
    if rules is not None:
        out["shards"] = _shard_shapes(cfg, rules, params, caches)
    return out


def _replayed(xt, p, cfg, shards, queue):
    """``moe.route`` taking the next choices of ``queue`` instead of its
    own, weighted by its gates at those experts."""
    logits = xt.float() @ p["w_router"].float()
    if logits.shape[1] < cfg.n_experts:
        logits = shards.gather(logits, "model", 1)
    gates = torch.softmax(logits, dim=-1)
    top_i, queue[0] = queue[0][:xt.shape[0]], queue[0][xt.shape[0]:]
    top_w = gates.gather(1, top_i)
    return top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9), top_i


def _rows(rules):
    from repro_torch.sharding.collectives import Shards
    return Shards(rules, B).rows


def _paths(tree, at="") -> dict:
    """{"a/b/c": leaf} of a dict tree."""
    if not isinstance(tree, dict):
        return {at: tree}
    return {k: v for name, sub in tree.items()
            for k, v in _paths(sub, f"{at}/{name}").items()}


def _shard_shapes(cfg, rules, params, caches) -> dict:
    """This rank's local shapes of params and caches, and those that
    ``input_specs`` gives for the same cell, by leaf path."""
    from repro_torch.configs import Shape
    from repro_torch.train import input_specs
    specs = input_specs(cfg, Shape("tp", _max_seq(cfg), B, "prefill"), rules)
    want = {k: rules.local_shape(t.shape, t.spec) for k, t in _paths(
        {"params": specs["params"], "caches": specs["caches"]}).items()}
    got = {k: tuple(t.to_local().shape) for k, t in _paths(
        {"params": params, "caches": caches}).items()}
    return {"got": got, "want": want, "rows": _rows(rules)}


@torch.no_grad()
def _moe_layer(rules, leaves) -> dict:
    """qwen3's first MoE layer alone, sharded on this rank's rows against
    the unsharded layer on the whole batch (its rows), in f32, with
    capacity factor 0.5 so that dispatches are dropped: by token groups
    ``MOE_GROUPS`` of the global ``B`` x ``MOE_SEQ`` tokens, which split
    over 2 data ranks (4 groups), span them (1) or split some groups
    between them (3).  Also the dispatches the unsharded layer drops."""
    import dataclasses

    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models import moe
    from repro_torch.sharding import Shards
    base = get_reduced(MOE)
    whole = lm_params_from_arrays(leaves, device="cpu")
    sharded = lm_params_from_arrays(leaves, device="cpu", cfg=base,
                                    rules=rules)
    shards = Shards(rules, B)
    kind = base.pattern[0]
    p = {n: a[0] for n, a in whole["blocks"][kind].items()}
    local = {n: shards.at_use(a, 0)
             for n, a in sharded["blocks"][kind].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, MOE_SEQ, base.d_model)).astype(np.float32))
    lo, hi = shards.rows
    out = {}
    for g in MOE_GROUPS:
        cfg = dataclasses.replace(base, capacity_factor=0.5, moe_groups=g)
        per = B * MOE_SEQ // g
        dropped = sum(int((moe._positions_in_expert(
            moe.route(xg, p, cfg)[1].reshape(-1), cfg.n_experts)
            >= moe.capacity(cfg, per)).sum())
            for xg in x.reshape(g, per, -1))
        out[g] = (moe.moe_ffn(x[lo:hi], local, cfg, shards=shards),
                  moe.moe_ffn(x, p, cfg)[lo:hi], dropped)
    return out


# -- the ranks (spawned) ----------------------------------------------------------
def serve_ranks(rank, world, out, shape, leaves, replay):
    """Every case of one mesh; each rank returns what it saw.  ``replay``
    holds the JAX package's bf16 expert choices by arch."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import make_rules
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rules = make_rules(mesh)
    res = {(arch, dtype): _port_run(
        arch, leaves[arch], dtype, rules,
        replay.get(arch) if dtype == "bfloat16" else None)
        for arch in ARCHS for dtype in DTYPES}
    res["moe_layer"] = _moe_layer(rules, leaves[MOE])
    if shape[1] > 1:
        res["train"] = _train_metrics(rules)
    if shape == (1, 1):
        from repro_torch.convert import lm_params_from_arrays
        from repro_torch.models.params import shard_params
        from repro_torch.pytree import tree_leaves
        cfg = get_reduced(MOE)
        whole = lm_params_from_arrays(leaves[cfg.name], device="cpu")
        sharded = shard_params(whole, cfg, rules)
        res["no_copy"] = all(
            a.data_ptr() == b.to_local().data_ptr()
            for a, b in zip(tree_leaves(whole), tree_leaves(sharded)))
    return res


def _train_metrics(rules) -> dict:
    """One f32 train step of reduced olmo-1b, one microbatch: sharded under
    ``rules``, or unsharded (``rules`` None)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm as TLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, init_train_state
    cfg, opt = get_reduced("olmo_1b"), AdamWConfig()
    state = init_train_state(cfg, 0, opt_cfg=opt, device="cpu", rules=rules)
    step = build_train_step(cfg, opt, rules=rules)
    with mock.patch.object(TLM, "COMPUTE_DTYPE", torch.float32):
        _, m = step(state, TokenPipeline(cfg, B, 32, seed=0).batch_at(0))
    return {k: float(v) for k, v in m.items()}


# -- the references and the runs ---------------------------------------------------
def _jax_run(arch, leaves, dtype) -> dict:
    """The JAX package's prefill and decode steps with ``rules=None``, and
    per stage its expert choices, (MoE layers, tokens, k) (recorded from
    its ``jax.lax.top_k`` as the layers run)."""
    import jax
    import jax.numpy as jnp

    from repro import models as J
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import lm as JLM
    jcfg = jax_get_reduced(arch)
    toks, extra = _inputs(get_reduced(arch))
    kw = {{"patches": "frontend"}.get(k, k): jnp.asarray(v)
          for k, v in extra.items()}
    jp = jax.tree.map(jnp.asarray, leaves)
    jdt = getattr(jnp, dtype)
    top_k, calls = jax.lax.top_k, []

    def recording(x, k):
        w, i = top_k(x, k)
        jax.debug.callback(lambda a: calls.append(np.asarray(a)), i,
                           ordered=True)
        return w, i

    def stage_routes():
        jax.effects_barrier()
        n = sum(k.endswith("+moe") for k in jcfg.pattern) * jcfg.n_repeat
        got = (np.concatenate(calls).reshape(n, -1, jcfg.experts_per_token)
               if n else None)
        calls.clear()
        return got

    out = {"logits": [], "routes": []}
    with mock.patch.object(JLM, "COMPUTE_DTYPE", jdt), \
            mock.patch.object(jax.lax, "top_k", recording):
        jc = J.init_cache(jcfg, B, _max_seq(jcfg), dtype=jdt)
        logits, jc = J.prefill(jp, jcfg, jnp.asarray(toks[:, :S]), jc, **kw)
        out["logits"].append(logits)
        out["routes"].append(stage_routes())
        out["prefill_caches"] = jc
        step = jax.jit(lambda p, t, c, pos: J.decode_step(p, jcfg, t, c, pos))
        for i in range(STEPS):
            logits, jc = step(jp, jnp.asarray(toks[:, S + i:S + i + 1]), jc,
                              jnp.int32(S + i + jcfg.frontend_tokens))
            out["logits"].append(logits)
            out["routes"].append(stage_routes())
    out["caches"] = jc
    routes = out.pop("routes")
    out = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)),
                       out)
    return dict(out, routes=routes)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """The expert choices every bf16 run of the port replays (the JAX
    package's for the attention families' MoE archs, the port's own
    unsharded ones for jamba, which is held in bf16 against the port
    only), then every mesh's spawn (in a thread, one after another) while
    the other JAX references and the port's unsharded runs are made
    here."""
    leaves = {arch: _leaves(arch) for arch in ARCHS}
    moe = [a for a in ATTN if get_reduced(a).n_experts]
    jax_ref = {(a, "bfloat16"): _jax_run(a, leaves[a], "bfloat16")
               for a in moe}
    replay = {a: jax_ref[a, "bfloat16"]["routes"] for a in moe}
    port = {(a, "bfloat16"): _port_run(a, leaves[a], "bfloat16")
            for a in RECURRENT}
    replay["jamba_v01_52b"] = port["jamba_v01_52b", "bfloat16"]["routes"]

    def spawns():
        return {shape: spawn(serve_ranks, shape[0] * shape[1],
                             tmp_path_factory.mktemp("x".join(map(str,
                                                                  shape))),
                             shape, leaves, replay)
                for shape in MESHES}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawns)
        for case, dtype in _jax_cases():
            arch = case[1]
            if (arch, dtype) not in jax_ref:
                jax_ref[arch, dtype] = _jax_run(arch, leaves[arch], dtype)
        for arch in ARCHS:
            for dtype in DTYPES:
                if (arch, dtype) not in port:
                    port[arch, dtype] = _port_run(
                        arch, leaves[arch], dtype, replay=replay.get(arch)
                        if dtype == "bfloat16" else None)
        train = _train_metrics(None)
        return {"ranks": ranks.result(), "jax": jax_ref, "port": port,
                "train": train}


def _cases():
    return [(shape, arch) for shape in MESHES for arch in ARCHS]


def _id(case):
    return f"{case[0][0]}x{case[0][1]}-{case[1]}"


def _outputs(run) -> list:
    """(name, array) of every logits stage and every cache leaf."""
    out = [(f"logits[{i}]", t) for i, t in enumerate(run["logits"])]
    for stage in ("prefill_caches", "caches"):
        for kind, leaves in sorted(run[stage].items()):
            out += [(f"{stage}[{kind}][{name}]", t)
                    for name, t in sorted(leaves.items())]
    return out


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else t


def _same_routes(run, want, what) -> None:
    """The rank's expert choices in every stage are the reference's for
    its tokens (``want``: every token's)."""
    lo, hi = run["shards"]["rows"]
    for stage, (r, w) in enumerate(zip(run["routes"], want)):
        if w is None:
            continue
        w = torch.as_tensor(w)
        s = w.shape[1] // B                           # tokens per row
        assert torch.equal(r.sort(-1).values,
                           w[:, lo * s:hi * s].sort(-1).values), (what, stage)


# -- the checks ----------------------------------------------------------------
@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_sharded_equals_the_unsharded_port(runs, case):
    """f32 within 1e-5 and the same experts for every token; on the mesh of
    one every output bit for bit, in f32 and bf16."""
    shape, arch = case
    want = runs["port"][arch, "float32"]
    for got in runs["ranks"][shape]:
        run = got[arch, "float32"]
        for (name, a), (_, b) in zip(_outputs(run), _outputs(want)):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(_np(a), _np(b), err_msg=name,
                                       **F32_PORT)
        _same_routes(run, want["routes"], "port")
        if shape == (1, 1):
            for dtype in DTYPES:
                pairs = zip(_outputs(got[arch, dtype]),
                            _outputs(runs["port"][arch, dtype]))
                assert all(torch.equal(a, b) for (_, a), (_, b) in pairs)


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_sharded_bf16_equals_the_unsharded_port(runs, case):
    """bf16 within 5e-2 of the port's unsharded bf16 (both taking the JAX
    package's bf16 expert choices)."""
    shape, arch = case
    want = _outputs(runs["port"][arch, "bfloat16"])
    for got in runs["ranks"][shape]:
        pairs = list(zip(_outputs(got[arch, "bfloat16"]), want))
        assert len(pairs) == len(want)
        for (name, a), (_, b) in pairs:
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **BF16)


def _jax_cases():
    # jamba's and rwkv6's bf16 lie further than 5e-2 from the JAX
    # package's in both packages' unsharded paths (test_torch_lm.py)
    return [(case, dtype) for case in _cases() for dtype in DTYPES
            if dtype == "float32" or case[1] not in ("jamba_v01_52b",
                                                     "rwkv6_1p6b")]


@pytest.mark.parametrize("case,dtype", _jax_cases(),
                         ids=lambda c: c if isinstance(c, str) else _id(c))
def test_sharded_equals_jax(runs, case, dtype):
    """f32 within 1e-4 with every token routed as the JAX package routes
    it; bf16 within 5e-2 (the port taking the JAX package's experts)."""
    shape, arch = case
    ref = runs["jax"][arch, dtype]
    want = _outputs(ref)
    for got in runs["ranks"][shape]:
        run = got[arch, dtype]
        pairs = list(zip(_outputs(run), want))
        assert len(pairs) == len(want)
        for (name, a), (_, b) in pairs:
            assert a.shape == b.shape, name
            if name.endswith("[slot_pos]"):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
            else:
                np.testing.assert_allclose(
                    _np(a), b, err_msg=name,
                    **(F32_JAX if dtype == "float32" else BF16))
        if dtype == "float32":
            _same_routes(run, ref["routes"], "jax")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_shards_have_the_local_shapes_of_input_specs(runs, shape):
    for got in runs["ranks"][shape]:
        for arch in ARCHS:
            sh = got[arch, "float32"]["shards"]
            assert sh["got"] == sh["want"], arch


def test_shards_are_split_where_the_rules_say(runs):
    """qwen3's caches split ``head_dim`` on (1, 4) and kv heads on (1, 2);
    its experts, vocab and rows split as the mesh allows."""
    arch = MOE
    cfg = get_reduced(arch)

    def local(shape, path=None):
        got = runs["ranks"][shape][0][arch, "float32"]["shards"]["got"]
        return got if path is None else got[path]

    k, e = "/caches/attn+moe/k", "/params/blocks/attn+moe/w_gate"
    d, f, n = cfg.d_model, cfg.expert_ff, cfg.n_experts
    assert local((1, 1), k) == (2, B, _max_seq(cfg), 2, 16)
    assert local((1, 4), k) == (2, B, _max_seq(cfg), 2, 4)
    assert local((1, 2), k) == (2, B, _max_seq(cfg), 1, 16)
    assert local((2, 2), k) == (2, B // 2, _max_seq(cfg), 1, 16)
    assert local((1, 3)) == local((1, 1))        # nothing divides 3
    assert local((1, 4), e) == (2, n // 4, d, f)
    assert local((2, 2), e) == (2, n // 2, d // 2, f)
    assert local((2, 2), "/params/embed") == (cfg.vocab_size // 2, d // 2)
    assert local((1, 1), "/params/embed") == (cfg.vocab_size, d)


def test_recurrent_shards_are_split_where_the_rules_say(runs):
    """jamba's mamba caches split its inner dim over "model", whisper's
    cross-attention caches its heads, rwkv6's WKV state stays whole (each
    rank gathers its heads' new state back) while its channel mix's hidden
    dim splits at rest; on (1, 3) nothing divides."""
    def local(shape, arch, path):
        return runs["ranks"][shape][0][arch, "float32"]["shards"]["got"][
            path]

    jamba, rwkv, whisper = (get_reduced(a) for a in RECURRENT)
    di, n, k = jamba.d_inner, jamba.ssm_state, jamba.ssm_conv
    for shape, m in (((1, 1), 1), ((1, 2), 2), ((2, 2), 2), ((1, 4), 4),
                     ((1, 3), 1)):
        b = B // shape[0]
        assert local(shape, "jamba_v01_52b", "/caches/mamba+mlp/conv") == \
            (3, b, k - 1, di // m)
        assert local(shape, "jamba_v01_52b", "/caches/mamba+moe/h") == \
            (4, b, di // m, n)
        assert local(shape, "whisper_small", "/caches/attn+mlp/xk") == (
            2, b, whisper.encoder_seq, whisper.n_heads // m,
            whisper.head_dim)
        assert local(shape, "rwkv6_1p6b", "/caches/rwkv+cmix/S") == (
            2, b, rwkv.rwkv_heads, rwkv.rwkv_head_dim, rwkv.rwkv_head_dim)
        assert local(shape, "rwkv6_1p6b",
                     "/params/blocks/rwkv+cmix/cm_k") == (
            2, rwkv.d_model // shape[0], rwkv.d_ff // m)


@pytest.mark.parametrize("shape", [s for s in MESHES if s[1] > 1],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_step_runs_on_the_model_axis(runs, shape):
    want = runs["train"]
    for got in runs["ranks"][shape]:
        m = got["train"]
        assert abs(m["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        assert abs(m["grad_norm"] - want["grad_norm"]) <= (
            1e-5 * want["grad_norm"])
        assert m["lr"] == want["lr"]


@pytest.mark.parametrize("groups", MOE_GROUPS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_groups_and_capacity_are_the_global_batch(runs, shape, groups):
    """A MoE layer that drops dispatches gives each rank's rows the
    unsharded layer's output within 1e-5 (f32): the token groups and the
    capacity are the global batch's, and a group that spans data ranks
    ranks its dispatches in the global order."""
    for got in runs["ranks"][shape]:
        y, want, dropped = got["moe_layer"][groups]
        assert dropped > 0
        assert y.shape == want.shape
        np.testing.assert_allclose(y.numpy(), want.numpy(), **F32_PORT)


def test_shard_params_copies_nothing_on_a_mesh_of_one(runs):
    assert runs["ranks"][(1, 1)][0]["no_copy"]
