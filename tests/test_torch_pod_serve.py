"""Sharded serving over a ("pod", "data", "model") ``DeviceMesh`` on
``gloo`` ranks on the CPU: ``build_prefill_step``/``build_decode_step``
with ``make_rules(mesh)`` on the JAX package's multi-pod axes, against the
JAX package's ``prefill``/``decode_step`` with ``rules=None`` and against
the port's unsharded path.

The rules put the batch over ("pod", "data") (pod-major), the FSDP
``embed`` dim of the params over ("pod", "data") too (gathered at use, the
minor axis first), and heads, kv heads, ``mlp``, experts, mamba's inner
dim, rwkv6's heads and the vocab over "model".  One spawn per mesh
(``torch_ranks.spawn``, one torch thread a rank): (2, 1, 1), (2, 2, 1),
(2, 1, 2) and (1, 2, 2).

The cases are ``test_torch_tp.py``'s (its helpers run them): reduced
olmo-1b (an attention family), qwen3-moe (its decode batch of 4 is one
token group, which spans every batch shard, and its prefill groups split
over them), jamba (mamba and MoE) and rwkv6, a prefill of 4 x 16 tokens
then 4 decode steps on fixed tokens; and qwen3's first MoE layer alone at
capacity factor 0.5 in 1, 3 or 4 token groups of 4 x 48 tokens.

What is held, each rank's gathered logits (prefill and every decode step)
and every cache leaf (after prefill and after the last step), at
``test_torch_tp.py``'s tolerances, fixed before the first run:

- against the JAX package: f32 compute at ``rtol=atol=1e-4`` with every
  token routed to the experts the JAX package picks; olmo-1b and qwen3 in
  bf16 at 5e-2 (qwen3 taking the JAX package's bf16 expert choices, as
  there);
- against the port's unsharded path: f32 at 1e-4, bf16 at 5e-2.  (f32 at
  ``test_torch_tp.py``'s 1e-5 holds everywhere but jamba on (2, 2, 1),
  one row a rank, whose last decode logits lie 1.7e-5 from the unsharded
  path's: the same numbers as on the 2-axis mesh (4, 1), one row a rank
  too, so a GEMM over one row, not the pod axis, moves the last bits that
  mamba's recurrence carries);
- each rank's rows of the batch are its stretch at its (pod, data) index,
  pod-major, and its param and cache shards have ``input_specs``' local
  shapes (the embedding's ``embed`` columns split over pod x data);
- the MoE layer alone: each rank's rows equal the unsharded layer's
  within 1e-5, with dropped dispatches, whether the groups span the batch
  shards, split some of them or fall whole to each.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from test_torch_tp import (B, BF16, F32_JAX, F32_PORT, MOE, MOE_GROUPS,
                           _jax_run, _leaves, _moe_layer, _np, _outputs,
                           _port_run, _same_routes)
from torch_ranks import spawn

AXES = ("pod", "data", "model")
MESHES = ((2, 1, 1), (2, 2, 1), (2, 1, 2), (1, 2, 2))
ARCHS = ("olmo_1b", MOE, "jamba_v01_52b", "rwkv6_1p6b")
BF16_ARCHS = ("olmo_1b", MOE)


def pod_ranks(rank, world, out, shape, leaves, replay):
    """Every case of one mesh; each rank returns what it saw."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import make_rules
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
    rules = make_rules(mesh)
    res = {(arch, "float32"): _port_run(arch, leaves[arch], "float32",
                                        rules) for arch in ARCHS}
    res.update({(arch, "bfloat16"): _port_run(
        arch, leaves[arch], "bfloat16", rules, replay.get(arch))
        for arch in BF16_ARCHS})
    res["moe_layer"] = _moe_layer(rules, leaves[MOE])
    res["coords"] = tuple(mesh.get_local_rank(a) for a in AXES)
    return res


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """qwen3's bf16 expert choices from the JAX package first (every bf16
    run of qwen3 replays them), then the spawns (in a thread, one after
    another) while the other references are made here."""
    leaves = {arch: _leaves(arch) for arch in ARCHS}
    jax_ref = {(MOE, "bfloat16"): _jax_run(MOE, leaves[MOE], "bfloat16")}
    replay = {MOE: jax_ref[MOE, "bfloat16"]["routes"]}

    def spawns():
        return {shape: spawn(pod_ranks, int(np.prod(shape)),
                             tmp_path_factory.mktemp("x".join(map(str,
                                                                  shape))),
                             shape, leaves, replay)
                for shape in MESHES}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawns)
        port = {}
        for arch in ARCHS:
            jax_ref[arch, "float32"] = _jax_run(arch, leaves[arch],
                                                "float32")
            port[arch, "float32"] = _port_run(arch, leaves[arch], "float32")
        jax_ref["olmo_1b", "bfloat16"] = _jax_run(
            "olmo_1b", leaves["olmo_1b"], "bfloat16")
        for arch in BF16_ARCHS:
            port[arch, "bfloat16"] = _port_run(arch, leaves[arch],
                                               "bfloat16", replay=replay.get(
                                                   arch))
        return {"ranks": ranks.result(), "jax": jax_ref, "port": port}


def _cases():
    return [(shape, arch) for shape in MESHES for arch in ARCHS]


def _id(case):
    return "x".join(map(str, case[0])) + f"-{case[1]}"


def _dtypes(arch):
    return ("float32", "bfloat16") if arch in BF16_ARCHS else ("float32",)


def _held(run, want, tol) -> None:
    pairs = list(zip(_outputs(run), _outputs(want)))
    assert len(pairs) == len(_outputs(want))
    for (name, a), (_, b) in pairs:
        assert a.shape == b.shape, name
        if name.endswith("[slot_pos]"):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
        else:
            np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **tol)


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_pod_serving_equals_the_unsharded_port(runs, case):
    shape, arch = case
    for got in runs["ranks"][shape]:
        for dtype in _dtypes(arch):
            want = runs["port"][arch, dtype]
            _held(got[arch, dtype], want,
                  F32_JAX if dtype == "float32" else BF16)
            for (name, a), (_, b) in zip(_outputs(got[arch, dtype]),
                                         _outputs(want)):
                assert a.dtype == b.dtype, name
        _same_routes(got[arch, "float32"], runs["port"][arch, "float32"][
            "routes"], "port")


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_pod_serving_equals_jax(runs, case):
    shape, arch = case
    for got in runs["ranks"][shape]:
        for dtype in _dtypes(arch):
            ref = runs["jax"][arch, dtype]
            _held(got[arch, dtype], ref,
                  F32_JAX if dtype == "float32" else BF16)
        _same_routes(got[arch, "float32"], runs["jax"][arch, "float32"][
            "routes"], "jax")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_pod_rows_and_shards_follow_the_rules(runs, shape):
    """Rows at the (pod, data) index, pod-major; local shapes of
    ``input_specs``; the embedding's columns over pod x data."""
    pods, data, model = shape
    cfg = get_reduced("olmo_1b")
    for got in runs["ranks"][shape]:
        pod, d, _ = got["coords"]
        m = B // (pods * data)
        idx = pod * data + d
        for arch in ARCHS:
            sh = got[arch, "float32"]["shards"]
            assert sh["got"] == sh["want"], arch
            assert tuple(sh["rows"]) == (idx * m, (idx + 1) * m), arch
        embed = got["olmo_1b", "float32"]["shards"]["got"]["/params/embed"]
        assert embed == (cfg.vocab_size // model,
                         cfg.d_model // (pods * data))


@pytest.mark.parametrize("groups", MOE_GROUPS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_pod_moe_groups_and_capacity_are_the_global_batch(runs, shape,
                                                          groups):
    for got in runs["ranks"][shape]:
        y, want, dropped = got["moe_layer"][groups]
        assert dropped > 0
        assert y.shape == want.shape
        np.testing.assert_allclose(y.numpy(), want.numpy(), **F32_PORT)
