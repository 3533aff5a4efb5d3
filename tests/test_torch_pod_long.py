"""The batch-1 long-context layout over a ("pod", "data", "model")
``DeviceMesh`` on ``gloo`` ranks on the CPU: ``make_rules(mesh,
batch_divisible=False, seq_sharded_decode=True)`` puts ``cache_seq`` over
all three axes, so each rank holds a stretch [c0, c0 + n) of every KV
cache's ring slots (pod-major rank order), every rank takes the whole
batch of one, decode combines the ranks' softmax over the three axes, and
the rest splits over "model" as the serving rules do.  Against the JAX
package's ``prefill``/``decode_step`` with ``rules=None`` and the port's
unsharded path.

The cases are ``test_torch_long_context.py``'s (its helpers run them):
reduced ``h2o_danube_1p8b`` (a 16-slot sliding-window ring, 4 slots a rank
on 4 ranks) and ``jamba_v01_52b`` (one attention layer, a 32-slot ring,
its mamba and MoE layers), a prompt of 20 tokens then 10 decode steps,
which wrap danube's ring and move the newest slot from rank to rank.  One
spawn per mesh: (2, 1, 1), (2, 2, 1), (2, 1, 2) and (1, 2, 2).

What is held, each rank's gathered logits (prefill and every decode step)
and every cache leaf (after prefill and after the last step), fixed
before the first run:

- against the JAX package in f32 compute at ``rtol=atol=1e-4``, danube in
  bf16 at 5e-2; ``slot_pos`` equal;
- against the port's unsharded path: f32 at 1e-5, danube's bf16 at 5e-2;
- each rank's param and cache shards have ``input_specs``' local shapes,
  its k/v cache shards are laid out ``Shard(2)`` on every mesh dim and
  hold ring slots [c0, c0 + n) of the whole cache, c0 = ((pod x data size
  + data) x model size + model) x n.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from test_torch_long_context import (_jax_run, _long_rules, _port_run)
from test_torch_tp import BF16, F32_JAX, F32_PORT, _leaves, _np, _outputs
from torch_ranks import spawn

AXES = ("pod", "data", "model")
MESHES = ((2, 1, 1), (2, 2, 1), (2, 1, 2), (1, 2, 2))
ARCHS = ("h2o_danube_1p8b", "jamba_v01_52b")
BF16_ARCH = "h2o_danube_1p8b"


def pod_long_ranks(rank, world, out, shape, leaves):
    """Every case of one mesh; each rank returns what it saw."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
    rules = _long_rules(mesh)
    res = {(arch, "float32"): _port_run(arch, leaves[arch], "float32", rules)
           for arch in ARCHS}
    res[BF16_ARCH, "bfloat16"] = _port_run(BF16_ARCH, leaves[BF16_ARCH],
                                           "bfloat16", rules)
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
    leaves = {arch: _leaves(arch) for arch in ARCHS}

    def spawns():
        return {shape: spawn(pod_long_ranks, int(np.prod(shape)),
                             tmp_path_factory.mktemp("x".join(map(str,
                                                                  shape))),
                             shape, leaves)
                for shape in MESHES}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawns)
        cases = [(a, "float32") for a in ARCHS] + [(BF16_ARCH, "bfloat16")]
        jax_ref = {(a, d): _jax_run(a, leaves[a], d) for a, d in cases}
        port = {(a, d): _port_run(a, leaves[a], d) for a, d in cases}
        return {"ranks": ranks.result(), "jax": jax_ref, "port": port}


def _cases():
    return [(shape, arch, dtype) for shape in MESHES for arch in ARCHS
            for dtype in ("float32", "bfloat16")
            if dtype == "float32" or arch == BF16_ARCH]


def _id(case):
    return "x".join(map(str, case[0])) + f"-{case[1]}-{case[2]}"


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_pod_long_context_equals_the_unsharded_port(runs, case):
    shape, arch, dtype = case
    want = _outputs(runs["port"][arch, dtype])
    for got in runs["ranks"][shape]:
        pairs = list(zip(_outputs(got[arch, dtype]), want))
        assert len(pairs) == len(want)
        for (name, a), (_, b) in pairs:
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(
                _np(a), _np(b), err_msg=name,
                **(F32_PORT if dtype == "float32" else BF16))


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_pod_long_context_equals_jax(runs, case):
    shape, arch, dtype = case
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


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_pod_cache_shards_hold_their_ring_slots(runs, shape):
    from torch.distributed.tensor import Shard
    _, data, model = shape
    for got in runs["ranks"][shape]:
        pod, d, r = got["coords"]
        for arch in ARCHS:
            run = got[arch, "float32"]
            sh = run["shards"]
            assert sh["got"] == sh["want"], arch
            for path, (local, placements) in sh["kv"].items():
                kind, name = path.split("/")
                whole = run["caches"][kind][name]
                n = whole.shape[2] // int(np.prod(shape))
                assert local.shape[2] == n, (arch, path)
                assert placements == (Shard(2),) * 3, (arch, path)
                c0 = ((pod * data + d) * model + r) * n
                assert torch.equal(local, whole[:, :, c0:c0 + n]), (
                    arch, path)
