"""The dry run counts what the step moves: ``launch.dryrun.
shards_collectives`` (the step on fake tensors at rank 0's shapes over a
device-free mesh, at 1 and 2 pattern repeats, extrapolated) against the
bytes that the real ``Shards``' collectives move on ``gloo`` ranks on the
CPU, each recorded as it runs (on rank 0), byte for byte by type.

One spawn of 4 ranks, two ("pod", "data", "model") meshes, (2, 1, 2) and
(2, 2, 1), fixed before the first run:

- a multi-pod train cell: reduced qwen3-moe at 3 layers and reduced
  olmo-1b (tensor-parallel rules) at 3 layers, 4 x 32 tokens in 2
  microbatches, through ``train.sharded_grads`` (the gathers at use over
  ("pod", "data") and their reduce-scatters, the "model" sums, the
  router's gathers, the loss's sums over the batch axes, the all-reduce of
  the gradients replicated over them; the squared norm's 4 bytes, which
  ``DTensor`` reduces, are taken off the count);
- serving cells: reduced qwen3-moe's prefill of 4 x 32 tokens and one
  decode step after it (``build_prefill_step``/``build_decode_step``
  under ``make_rules(mesh)``), and reduced jamba's decode step in the
  batch-1 long-context layout (the softmax combine over all three axes).
"""
import dataclasses
from unittest import mock

import pytest
import torch

from repro_torch.configs import Shape, get_reduced
from test_torch_tp_train import batch_of
from torch_ranks import spawn

AXES = ("pod", "data", "model")
MESHES = ((2, 1, 2), (2, 2, 1))
B, S, ACCUM, LAYERS = 4, 32, 2, 3
TRAIN = ("qwen3_moe_235b_a22b", "olmo_1b")
SERVE = (("qwen3_moe_235b_a22b", "prefill"), ("qwen3_moe_235b_a22b",
                                              "decode"),
         ("jamba_v01_52b", "long"))


def _cfg(arch):
    cfg = get_reduced(arch)
    return dataclasses.replace(cfg, n_layers=LAYERS * len(cfg.pattern))


def _cell(step):
    if step == "long":
        return Shape("long_500k", S, 1, "decode")
    return Shape(f"{step}_32k" if step != "train" else "train_4k", S, B,
                 step)


def _rules(mesh, step):
    from repro_torch.sharding import make_rules
    if step == "long":
        return make_rules(mesh, batch_divisible=False,
                          seq_sharded_decode=True)
    return make_rules(mesh)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def recording():
    """(patches of ``Shards``' three collectives that record their bytes
    as they run, the record)."""
    from repro_torch.sharding import collectives as C
    moved = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    ar, ag, rs = (C.Shards._all_reduce, C.Shards._all_gather,
                  C.Shards._reduce_scatter)

    def all_reduce(self, t, op, groups):
        moved["all-reduce"] += len(groups) * _nbytes(t)
        return ar(self, t, op, groups)

    def all_gather(self, t, group, n, dim):
        out = ag(self, t, group, n, dim)
        moved["all-gather"] += _nbytes(out)
        return out

    def reduce_scatter(self, t, group, n, dim):
        out = rs(self, t, group, n, dim)
        moved["reduce-scatter"] += _nbytes(out)
        return out

    patches = (mock.patch.object(C.Shards, "_all_reduce", all_reduce),
               mock.patch.object(C.Shards, "_all_gather", all_gather),
               mock.patch.object(C.Shards, "_reduce_scatter",
                                 reduce_scatter))
    return patches, moved


def _run(patches, fn):
    with patches[0], patches[1], patches[2]:
        fn()


def train_moved(cfg, rules) -> dict:
    from repro_torch.train import init_train_state, sharded_grads
    state = init_train_state(cfg, 0, device="cpu", rules=rules)
    batch = {k: torch.as_tensor(v) for k, v in batch_of(cfg).items()}
    patches, moved = recording()
    _run(patches, lambda: sharded_grads(cfg, state.params, batch, rules,
                                        accum=ACCUM))
    return moved


def serve_moved(cfg, rules, step) -> dict:
    """The bytes of one prefill (``step`` "prefill"), or of one decode
    step after an unrecorded prefill."""
    from repro_torch.data import make_batch
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.layers import COMPUTE_DTYPE
    from repro_torch.models.params import shard_params
    from repro_torch.pytree import tree_map
    from repro_torch.train import build_decode_step, build_prefill_step
    b = 1 if step == "long" else B
    toks = make_batch(cfg, b, S, step=0)["tokens"]
    # the serving cells' params are in the compute dtype (input_specs)
    params = shard_params(tree_map(lambda p: p.to(COMPUTE_DTYPE),
                                   init_params(cfg, 0, device="cpu")),
                          cfg, rules)
    caches = init_cache(cfg, b, S, device="cpu", rules=rules)
    prefill = build_prefill_step(cfg, rules)
    decode = build_decode_step(cfg, rules)
    patches, moved = recording()
    if step == "prefill":
        _run(patches, lambda: prefill(params, {"tokens": toks}, caches))
    else:
        prefill(params, {"tokens": toks[:, :S - 1]}, caches)
        _run(patches, lambda: decode(params, toks[:, S - 1:], caches,
                                     S - 1))
    return moved


def pod_count_ranks(rank, world, out):
    from torch.distributed.device_mesh import init_device_mesh
    res = {}
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
        for arch in TRAIN:
            res[shape, arch, "train"] = train_moved(_cfg(arch),
                                                    _rules(mesh, "train"))
        for arch, step in SERVE:
            res[shape, arch, step] = serve_moved(_cfg(arch),
                                                 _rules(mesh, step), step)
    return res if rank == 0 else None


@pytest.fixture(scope="module")
def moved(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return spawn(pod_count_ranks, 4, tmp_path_factory.mktemp("count"))[0]
    finally:
        torch.set_num_threads(n)


def _cases():
    return ([(shape, arch, "train") for shape in MESHES for arch in TRAIN]
            + [(shape, arch, step) for shape in MESHES
               for arch, step in SERVE])


def _id(case):
    return "x".join(map(str, case[0])) + f"-{case[1]}-{case[2]}"


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_dry_run_counts_what_the_pod_step_moves(moved, case):
    from repro_torch.launch import MeshShape
    from repro_torch.launch.dryrun import shards_collectives
    shape, arch, step = case
    rules = _rules(MeshShape(shape, AXES), step)
    settings = {"accum": ACCUM} if step == "train" else {}
    counted = shards_collectives(_cfg(arch), rules, _cell(step), settings)
    if step == "train":
        counted["all-reduce"] -= 4     # the squared norm, DTensor's
    got = moved[case]
    assert counted == got
    assert got["all-gather"] > 0                  # weights at use
    if shape[2] > 1:
        assert got["all-reduce"] > 0              # over "model"
    if step == "train" and shape[0] * shape[1] == 2:
        assert got["reduce-scatter"] > 0          # the rows split
