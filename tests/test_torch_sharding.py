"""The port's sharding rules and step specs against the JAX package's.

Both packages build their rules from a mesh with axis sizes and no devices
(the port's ``MeshShape``, the JAX package's ``jax.sharding.AbstractMesh``),
so no placeholder devices are needed.  Everything here is exact:

- the rule table, and ``Rules.spec`` equal to ``tuple(PartitionSpec)`` for
  every leaf of every arch's ``param_logical_axes`` with its shape (and
  without it), every cache leaf's logical axes, on the (16, 16),
  (2, 16, 16) and (1, 1) meshes, for every combination of ``make_rules``'
  flags;
- ``input_specs`` of every (arch, shape) cell of ``shape_cells`` with
  ``train_settings`` on the single-pod mesh, with the dry run's rules:
  leaves in ``jax.tree`` order with equal shapes, dtypes and specs (the
  JAX specs of each arch computed once, in a module-scoped fixture, since
  the reference's ``eval_shape(init_params)`` dominates the file's time);
- ``cache_logical_axes``;
- ``shard`` a no-op outside ``use_rules`` and on a plain tensor inside it;
- the seven cases of ``tests/test_sharding.py`` on a port mesh of one.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as JC
from repro import sharding as JS
from repro import train as JT
from repro.train import step as JTS
from repro.models import param_logical_axes as jax_param_axes
from repro_torch import configs as TC
from repro_torch import sharding as TS
from repro_torch import train as TT
from repro_torch.launch import MeshShape, make_production_mesh
from repro_torch.models import param_logical_axes
from repro_torch.models.params import param_shapes
from repro_torch.pytree import tree_leaves

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "one": ((1, 1), ("data", "model"))}
FLAGS = [dict(zip(("batch_divisible", "seq_sharded_decode", "seq_parallel",
                   "dp_only"), v))
         for v in itertools.product((True, False), repeat=4)]


def _meshes(name):
    shape, axes = MESHES[name]
    return MeshShape(shape, axes), AbstractMesh(shape, axes)


def _leaf_axes(axes, shapes):
    """(logical axes, shape) pairs of a param tree, in key order."""
    out = []
    for k in sorted(axes):
        if isinstance(axes[k], dict):
            out += _leaf_axes(axes[k], shapes[k])
        else:
            out.append((axes[k], tuple(shapes[k].shape)))
    return out


def _cases(arch):
    cfg = TC.get_config(arch)
    cases = _leaf_axes(param_logical_axes(cfg), param_shapes(cfg))
    for kind, leaves in TT.cache_logical_axes(cfg).items():
        # cache leaves at a decode cell's batch and length
        for name, ax in leaves.items():
            cases.append((ax, (4, 128, 32768, 16, 128, 8)[:len(ax)]))
    return cases


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_param_axes_equal_the_reference(arch):
    assert param_logical_axes(TC.get_config(arch)) == jax_param_axes(
        JC.get_config(arch))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_specs_equal_the_reference(arch, mesh):
    tmesh, jmesh = _meshes(mesh)
    cases = _cases(arch)
    for flags in FLAGS:
        tr, jr = TS.make_rules(tmesh, **flags), JS.make_rules(jmesh, **flags)
        assert tr.table == jr.table, flags
        for ax, shape in cases:
            assert tr.spec(ax, shape) == tuple(jr.spec(ax, shape)), (
                flags, ax, shape)
            assert tr.spec(ax) == tuple(jr.spec(ax)), (flags, ax)
            assert TS.mesh_spec(tr, ax, shape) == tr.spec(ax, shape)


def _dryrun_rules(make, mesh, sizes, shape, settings):
    """The rules the dry run builds for a cell (``run_cell``)."""
    return make(mesh, batch_divisible=(
        shape.global_batch % (sizes.get("pod", 1) * sizes["data"]) == 0),
        seq_sharded_decode=(shape.step == "decode"),
        seq_parallel=settings.get("seq_parallel", False),
        dp_only=settings.get("dp_only", False))


@pytest.fixture(scope="module")
def jax_specs():
    """arch -> shape name -> the JAX package's input_specs leaves as
    (shape, dtype name, spec), on the single-pod mesh."""
    cache = {}

    def get(arch):
        if arch not in cache:
            _, jmesh = _meshes("single_pod")
            cfg, out = JC.get_config(arch), {}
            for shape in JC.shape_cells(arch):
                st = JC.train_settings(arch) if shape.step == "train" else {}
                rules = _dryrun_rules(JS.make_rules, jmesh, dict(jmesh.shape),
                                      shape, st)
                out[shape.name] = [
                    (tuple(x.shape), str(np.dtype(x.dtype)),
                     () if x.sharding is None else tuple(x.sharding.spec))
                    for x in jax.tree.leaves(JT.input_specs(cfg, shape, rules,
                                                            st))]
            cache[arch] = out
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_input_specs_equal_the_reference(arch, jax_specs):
    want = jax_specs(arch)
    mesh = make_production_mesh()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cfg = TC.get_config(arch)
    assert [s.name for s in TC.shape_cells(arch)] == list(want)
    for shape in TC.shape_cells(arch):
        st = TC.train_settings(arch) if shape.step == "train" else {}
        rules = _dryrun_rules(TS.make_rules, mesh, sizes, shape, st)
        got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."), t.spec)
               for t in tree_leaves(TT.input_specs(cfg, shape, rules, st))]
        assert all(t.device.type == "meta" for t in tree_leaves(
            TT.input_specs(cfg, shape, rules, st)))
        assert got == want[shape.name], (arch, shape.name)


def test_input_specs_honour_the_train_settings():
    """qwen3-moe's train cell: bf16 params and moments per its settings."""
    cfg = TC.get_config("qwen3_moe_235b_a22b")
    rules = TS.make_rules(make_production_mesh())
    st = TC.train_settings("qwen3_moe_235b_a22b")
    state = TT.input_specs(cfg, TC.SHAPES["train_4k"], rules, st)["state"]
    for tree in (state.params, state.opt.mu, state.opt.nu):
        assert {t.dtype for t in tree_leaves(tree)} == {torch.bfloat16}
    assert state.ef is None and state.opt.step.dtype == torch.int32
    comp = TT.state_shardings(cfg, rules, compress=True)
    assert {t.dtype for t in tree_leaves(comp.ef)} == {torch.float32}
    assert [t.spec for t in tree_leaves(comp.ef)] == [
        t.spec for t in tree_leaves(comp.params)]


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_cache_logical_axes_equal_the_reference(arch):
    assert TT.cache_logical_axes(TC.get_config(arch)) == \
        JTS.cache_logical_axes(JC.get_config(arch))


def test_shard_is_a_no_op_without_rules_and_on_plain_tensors():
    x = torch.arange(6.0).reshape(2, 3)
    assert TS.current_rules() is None
    assert TS.shard(x, "act_batch", None) is x
    rules = TS.make_rules(MeshShape((16, 16), ("data", "model")))
    with TS.use_rules(rules) as r:
        assert r is rules and TS.current_rules() is rules
        assert TS.shard(x, "act_batch", "act_vocab") is x
    assert TS.current_rules() is None


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    rules = TS.make_rules(MeshShape((16, 16), ("data", "model")),
                          dp_only=True)
    assert rules.placements(("vocab", "embed"), (50304, 2048)) == (
        Shard(1), Shard(0))
    assert rules.placements(("act_batch", None), (256, 4096)) == (
        Shard(0), Shard(0))
    assert rules.placements(("layers", "embed", "mlp"), (16, 2048, 8)) == (
        Shard(1), Replicate())
    multi = TS.make_rules(MeshShape((2, 16, 16), ("pod", "data", "model")))
    assert multi.placements(("act_batch", None), (256, 4096)) == (
        Shard(0), Shard(0), Replicate())


def test_production_meshes():
    assert make_production_mesh() == MeshShape((16, 16), ("data", "model"))
    big = make_production_mesh(multi_pod=True)
    assert big.shape == (2, 16, 16) and big.size() == 512
    assert TS.make_rules(big).sizes == {"pod": 2, "data": 16, "model": 16}


# -- the seven cases of tests/test_sharding.py, on a port mesh of one ------
@pytest.fixture(scope="module")
def rules():
    return TS.make_rules(MeshShape((1, 1), ("data", "model")))


def test_basic_mapping(rules):
    assert rules.spec(("vocab", "embed")) == tuple(P("model", "data"))
    assert rules.spec(("act_batch", None, "act_vocab")) == tuple(P(
        "data", None, "model"))


def test_divisibility_fallback(rules):
    spec = rules.spec(("act_heads",), (40,))
    assert spec in (tuple(P("model")), tuple(P()))


def test_duplicate_axis_dedup(rules):
    spec = rules.spec(("act_seq", "act_mlp"), (64, 64))
    axes = [a for a in spec if a is not None]
    assert len(axes) == len(set(map(str, axes)))


def test_trailing_nones_trimmed(rules):
    assert rules.spec((None, None)) == tuple(P())


def test_seq_parallel_flips_act_seq():
    mesh = MeshShape((1, 1), ("data", "model"))
    assert TS.make_rules(mesh, seq_parallel=True).table["act_seq"] == "model"
    assert TS.make_rules(mesh).table["act_seq"] is None


def test_long_context_decode_rules():
    mesh = MeshShape((1, 1), ("data", "model"))
    r = TS.make_rules(mesh, batch_divisible=False, seq_sharded_decode=True)
    assert r.table["act_batch"] is None
    assert r.table["cache_seq"] == ("data", "model")


def test_fallback_on_nondivisible_dim():
    r = TS.make_rules(MeshShape((1, 1), ("data", "model")))
    assert r.spec(("act_vocab",), (7,)) == tuple(P("model"))
    # on a 16-way axis a dim of 7 drops it
    r16 = TS.make_rules(make_production_mesh())
    assert r16.spec(("act_vocab",), (7,)) == ()
