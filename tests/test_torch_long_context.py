"""Sharded serving in the batch-1 long-context layout (the ``long_500k``
cell's rules, ``make_rules(mesh, batch_divisible=False,
seq_sharded_decode=True)``) over a ("data", "model") ``DeviceMesh`` on
``gloo`` ranks on the CPU, against the JAX package's ``prefill``/
``decode_step`` with ``rules=None`` and against the port's unsharded path.

The rules put ``cache_seq`` over ("data", "model"): each rank holds a
stretch [c0, c0 + n) of every KV cache's ring slots (data-major rank
order), every rank takes the whole batch of one, and the rest splits over
"model" as the serving rules do (heads, mamba's inner dim, rwkv6's heads,
experts, vocab).  One spawn per mesh (``torch_ranks.spawn``): (1, 1), bit
for bit with the unsharded path; (2, 1), (1, 2), (2, 2) and (1, 4).

The configs: reduced ``h2o_danube_1p8b`` (sliding window 16, a 16-slot
ring), ``jamba_v01_52b`` (one attention layer, a 32-slot ring) and
``rwkv6_1p6b`` (no KV cache: its WKV state is whole on every rank).  A
prompt of ``S`` = 20 tokens, longer than danube's window, so prefill
writes the ring in two runs, then ``STEPS`` = 10 decode steps on fixed
tokens, which wrap danube's ring again and move the newest slot's owner
from rank to rank.  danube runs at the JAX package's init weights, jamba
and rwkv6 on randomized leaves (``test_torch_models.randomized``).

What is held, each rank's gathered logits (prefill and every decode step)
and every cache leaf (after prefill and after the last step), at
``tests/test_torch_tp.py``'s tolerances, fixed before the first run:

- against the JAX package in f32 compute at ``rtol=atol=1e-4``, and
  danube in bf16 at 5e-2 (jamba's and rwkv6's bf16 lie further from the
  JAX package's in the unsharded paths too, ``test_torch_lm.py``);
- against the port's unsharded path: f32 at 1e-5, bf16 at 5e-2 (jamba's
  sharded bf16 runs take the unsharded run's expert choices); on (1, 1)
  bit for bit in both dtypes;
- each rank's param and cache shards have ``input_specs``' local shapes,
  its k/v cache shards are laid out ``(Shard(2), Shard(2))`` and hold
  ring slots [c0, c0 + n) of the whole cache, c0 = (data rank x model
  size + model rank) x n.
"""
import concurrent.futures
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import make_batch
from repro_torch.pytree import tree_map
from test_torch_tp import (BF16, DTYPES, F32_JAX, F32_PORT, _leaves, _np,
                           _outputs, _paths, _replayed, _whole)
from torch_ranks import spawn

ARCHS = ("h2o_danube_1p8b", "jamba_v01_52b", "rwkv6_1p6b")
MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4))
B, S, STEPS, MAX_SEQ = 1, 20, 10, 32
JAX_BF16 = ("h2o_danube_1p8b",)


def _tokens(cfg):
    return make_batch(cfg, B, S + STEPS, step=0)["tokens"]


def _long_rules(mesh):
    from repro_torch.sharding import make_rules
    return make_rules(mesh, batch_divisible=False, seq_sharded_decode=True)


# -- the port, unsharded here or sharded in a rank ------------------------------
def _port_run(arch, leaves, dtype, rules=None, replay=None) -> dict:
    """Prefill of ``S`` tokens then ``STEPS`` decode steps through the
    port's step builders (sharded with ``rules``): the whole logits of each
    stage, the whole caches after prefill and after the last step, and the
    expert choices of each stage, (MoE layers, tokens, k); with ``replay``
    (such choices per stage) the MoE layers take those.  Sharded, also the
    rank's shards: their local shapes and ``input_specs``', and the local
    k/v cache shards after the last step with their placements."""
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models import init_cache, moe
    from repro_torch.models import lm as TLM
    from repro_torch.train import build_decode_step, build_prefill_step
    cfg = get_reduced(arch)
    toks = _tokens(cfg)
    tdt = getattr(torch, dtype)
    params = lm_params_from_arrays(leaves, device="cpu", cfg=cfg,
                                   rules=rules)
    caches = init_cache(cfg, B, MAX_SEQ, dtype=tdt, device="cpu",
                        rules=rules)
    prefill = build_prefill_step(cfg, rules)
    decode = build_decode_step(cfg, rules)
    route, calls, queue = moe.route, [], []
    n_moe = sum(k.endswith("+moe") for k in cfg.pattern) * cfg.n_repeat

    def recording(xt, p, cfg, router_bits=None, *, shards=None):
        out = (route(xt, p, cfg, router_bits, shards=shards)
               if replay is None else _replayed(xt, p, cfg, shards, queue))
        calls.append(out[1])
        return out

    def stage(i):
        if replay is not None and replay[i] is not None:
            queue[:] = [torch.as_tensor(replay[i]).reshape(
                -1, cfg.experts_per_token)]

    def stage_routes():
        got = (torch.cat(calls).reshape(n_moe, -1, cfg.experts_per_token)
               if n_moe else None)
        calls.clear()
        return got

    out = {"logits": [], "routes": []}
    with mock.patch.object(TLM, "COMPUTE_DTYPE", tdt), \
            mock.patch.object(moe, "route", recording):
        stage(0)
        logits, caches = prefill(params, {"tokens": toks[:, :S]}, caches)
        out["logits"].append(_whole(logits))
        out["routes"].append(stage_routes())
        out["prefill_caches"] = tree_map(_whole, caches)
        for i in range(STEPS):
            stage(i + 1)
            logits, caches = decode(params, toks[:, S + i:S + i + 1], caches,
                                    S + i)
            out["logits"].append(_whole(logits))
            out["routes"].append(stage_routes())
    assert not queue or not len(queue[0]), "every replayed choice taken"
    out["caches"] = tree_map(_whole, caches)
    if rules is not None:
        out["shards"] = _shards(cfg, rules, params, caches)
    return out


def _shards(cfg, rules, params, caches) -> dict:
    from repro_torch.configs import Shape
    from repro_torch.train import input_specs
    specs = input_specs(cfg, Shape("long", MAX_SEQ, B, "decode"), rules)
    want = {k: rules.local_shape(t.shape, t.spec) for k, t in _paths(
        {"params": specs["params"], "caches": specs["caches"]}).items()}
    got = {k: tuple(t.to_local().shape) for k, t in _paths(
        {"params": params, "caches": caches}).items()}
    kv = {f"{kind}/{name}": (t.to_local().clone(), tuple(t.placements))
          for kind, leaves in caches.items() for name, t in leaves.items()
          if name in ("k", "v")}
    mesh = rules.mesh
    return {"got": got, "want": want, "kv": kv,
            "coords": (mesh.get_local_rank("data"),
                       mesh.get_local_rank("model"))}


def long_ranks(rank, world, out, shape, leaves, replay):
    """Every case of one mesh; each rank returns what it saw."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rules = _long_rules(mesh)
    return {(arch, dtype): _port_run(
        arch, leaves[arch], dtype, rules,
        replay.get(arch) if dtype == "bfloat16" else None)
        for arch in ARCHS for dtype in DTYPES}


# -- the JAX reference -------------------------------------------------------------
def _jax_run(arch, leaves, dtype) -> dict:
    import jax
    import jax.numpy as jnp

    from repro import models as J
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import lm as JLM
    jcfg = jax_get_reduced(arch)
    toks = _tokens(get_reduced(arch))
    jp = jax.tree.map(jnp.asarray, leaves)
    jdt = getattr(jnp, dtype)
    out = {"logits": []}
    with mock.patch.object(JLM, "COMPUTE_DTYPE", jdt):
        jc = J.init_cache(jcfg, B, MAX_SEQ, dtype=jdt)
        logits, jc = J.prefill(jp, jcfg, jnp.asarray(toks[:, :S]), jc)
        out["logits"].append(logits)
        out["prefill_caches"] = jc
        step = jax.jit(lambda p, t, c, pos: J.decode_step(p, jcfg, t, c, pos))
        for i in range(STEPS):
            logits, jc = step(jp, jnp.asarray(toks[:, S + i:S + i + 1]), jc,
                              jnp.int32(S + i))
            out["logits"].append(logits)
    out["caches"] = jc
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)),
                        out)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """The port's unsharded bf16 runs first (jamba's sharded bf16 runs
    replay their expert choices), then every mesh's spawn (in a thread,
    one after another) while the JAX references and the port's unsharded
    f32 runs are made here."""
    leaves = {arch: _leaves(arch) for arch in ARCHS}
    port = {(a, "bfloat16"): _port_run(a, leaves[a], "bfloat16")
            for a in ARCHS}
    replay = {"jamba_v01_52b": port["jamba_v01_52b", "bfloat16"]["routes"]}

    def spawns():
        return {shape: spawn(long_ranks, shape[0] * shape[1],
                             tmp_path_factory.mktemp("x".join(map(str,
                                                                  shape))),
                             shape, leaves, replay)
                for shape in MESHES}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawns)
        jax_ref = {(a, d): _jax_run(a, leaves[a], d)
                   for a in ARCHS for d in DTYPES
                   if d == "float32" or a in JAX_BF16}
        for a in ARCHS:
            port[a, "float32"] = _port_run(a, leaves[a], "float32")
        return {"ranks": ranks.result(), "jax": jax_ref, "port": port}


def _cases():
    return [(shape, arch) for shape in MESHES for arch in ARCHS]


def _id(case):
    return f"{case[0][0]}x{case[0][1]}-{case[1]}"


# -- the checks ----------------------------------------------------------------
@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_long_context_equals_the_unsharded_port(runs, case):
    """f32 within 1e-5 of the unsharded port, bf16 within 5e-2; on the
    mesh of one every output bit for bit in both dtypes."""
    shape, arch = case
    for dtype, tol in (("float32", F32_PORT), ("bfloat16", BF16)):
        want = _outputs(runs["port"][arch, dtype])
        for got in runs["ranks"][shape]:
            pairs = list(zip(_outputs(got[arch, dtype]), want))
            assert len(pairs) == len(want)
            for (name, a), (_, b) in pairs:
                assert a.shape == b.shape and a.dtype == b.dtype, name
                if shape == (1, 1):
                    assert torch.equal(a, b), (dtype, name)
                np.testing.assert_allclose(_np(a), _np(b),
                                           err_msg=f"{dtype} {name}", **tol)


def _jax_cases():
    return [(case, dtype) for case in _cases() for dtype in DTYPES
            if dtype == "float32" or case[1] in JAX_BF16]


@pytest.mark.parametrize("case,dtype", _jax_cases(),
                         ids=lambda c: c if isinstance(c, str) else _id(c))
def test_long_context_equals_jax(runs, case, dtype):
    """f32 within 1e-4 of the JAX package; danube's bf16 within 5e-2;
    ``slot_pos`` equal."""
    shape, arch = case
    want = _outputs(runs["jax"][arch, dtype])
    for got in runs["ranks"][shape]:
        pairs = list(zip(_outputs(got[arch, dtype]), want))
        assert len(pairs) == len(want)
        for (name, a), (_, b) in pairs:
            assert a.shape == b.shape, name
            if name.endswith("[slot_pos]"):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
            else:
                np.testing.assert_allclose(
                    _np(a), b, err_msg=name,
                    **(F32_JAX if dtype == "float32" else BF16))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cache_shards_hold_their_ring_slots(runs, shape):
    """Local shapes of ``input_specs``; k/v split over both mesh dims,
    each rank's shard the slots [c0, c0 + n) of the whole cache in
    data-major rank order."""
    from torch.distributed.tensor import Shard
    m = shape[1]
    for got in runs["ranks"][shape]:
        for arch in ARCHS:
            run = got[arch, "float32"]
            sh = run["shards"]
            assert sh["got"] == sh["want"], arch
            d, r = sh["coords"]
            for path, (local, placements) in sh["kv"].items():
                kind, name = path.split("/")
                whole = run["caches"][kind][name]
                n = whole.shape[2] // (shape[0] * m)
                assert local.shape[2] == n, (arch, path)
                assert placements == (Shard(2), Shard(2)), (arch, path)
                c0 = (d * m + r) * n
                assert torch.equal(local, whole[:, :, c0:c0 + n]), (arch,
                                                                   path)


def test_ring_split_by_sequence_wraps_on_1x2(runs):
    """danube's 16-slot ring split over two ranks, 8 slots each: prefill
    of 20 tokens keeps positions 4-19 (slots 4-15 then 0-3), and decode
    positions 20-29 go to slots 4-13, on rank 0 and then on rank 1.  Every
    decode step's logits equal the unsharded port's within 1e-5 (f32) and
    the final ring holds positions 14-29."""
    arch = "h2o_danube_1p8b"
    want = runs["port"][arch, "float32"]
    kind = next(iter(want["caches"]))
    slot_pos = want["caches"][kind]["slot_pos"]
    assert sorted(slot_pos[0].tolist()) == list(range(14, 30))
    owners = {(p % 16) // 8 for p in range(S, S + STEPS)}
    assert owners == {0, 1}
    for got in runs["ranks"][(1, 2)]:
        run = got[arch, "float32"]
        assert torch.equal(run["caches"][kind]["slot_pos"], slot_pos)
        assert run["shards"]["kv"][f"{kind}/k"][0].shape[2] == 8
        for a, b in zip(run["logits"][1:], want["logits"][1:]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **F32_PORT)
