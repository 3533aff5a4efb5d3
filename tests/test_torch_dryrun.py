"""The port's dry run (``repro_torch.launch.dryrun``) on reduced configs.

The cells keep their meshes (16 x 16 and 2 x 16 x 16) and global batches
and run the reduced config of each arch at short sequences
(``get_config`` and ``SHAPES`` patched), so each takes about a second:

- ``memory.argument_bytes`` equals the sum over ``input_specs``' leaves of
  each leaf's per-device shard, worked out here from its spec;
- ``cost.flops`` equals ``FlopCounterMode`` over the same step on real
  tensors (the unsharded step, at the global shapes), divided by the
  devices that share the work (256 for olmo's ``dp_only`` train cell, 512
  for gemma's on two pods);
- the record has the reference's keys (read from
  ``src/repro/launch/dryrun.py`` without importing it, since importing it
  sets ``XLA_FLAGS``) plus ``derived``; what only a compiler gives is null;
- the CLI writes one record per cell, prints ``[ok]`` or ``[FAIL]`` per
  cell, skips an existing record only when asked and says so, and exits 1
  when any cell failed.
"""
import ast
import json
import math
import pathlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as TC
from repro_torch.launch import dryrun
from repro_torch.pytree import tree_leaves
from repro_torch.train import (build_decode_step, build_prefill_step,
                               build_train_step, init_train_state)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"train_4k": TC.Shape("train_4k", 32, 256, "train"),
         "prefill_32k": TC.Shape("prefill_32k", 64, 32, "prefill"),
         "decode_32k": TC.Shape("decode_32k", 64, 128, "decode"),
         "long_500k": TC.Shape("long_500k", 128, 1, "decode")}


def _reference_keys() -> set:
    """Keys of the reference's record, nested ones as 'outer.inner'."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "rec"
                        for t in node.targets)):
            keys = set()
            for k, v in zip(node.value.keys, node.value.values):
                keys.add(k.value)
                if isinstance(v, ast.Dict):
                    keys |= {f"{k.value}.{kk.value}" for kk in v.keys}
            return keys
    raise AssertionError("no rec = {...} in the reference's run_cell")


def _keys(rec) -> set:
    keys = set(rec)
    for k, v in rec.items():
        if isinstance(v, dict) and k in ("memory", "cost"):
            keys |= {f"{k}.{kk}" for kk in v}
    return keys


@pytest.fixture
def reduced(monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "get_config", TC.get_reduced)
    monkeypatch.setattr(dryrun, "SHAPES", dict(SMALL))
    monkeypatch.setattr(dryrun, "ART_DIR", str(tmp_path))
    return tmp_path


def _spec_bytes(t, sizes) -> int:
    div = 1
    for axis in t.spec:
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            div *= sizes.get(a, 1) if a else 1
    assert math.prod(t.shape) % div == 0
    return math.prod(t.shape) // div * t.element_size()


def _real_flops(arch, shape_name, settings) -> int:
    """The unsharded step on real CPU tensors at the cell's global shapes,
    under FlopCounterMode."""
    cfg, shape = TC.get_reduced(arch), SMALL[shape_name]
    b, s = shape.global_batch, shape.seq_len
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        if shape.step == "train":
            state = init_train_state(cfg, 0, device="cpu")
            build_train_step(cfg, accum=settings.get("accum", 1),
                             remat=settings.get("remat", "full"))(
                state, {"tokens": toks, "labels": toks})
        else:
            from repro_torch.models import init_cache
            from repro_torch.models.layers import COMPUTE_DTYPE
            from repro_torch.pytree import tree_map
            params = tree_map(lambda p: p.to(COMPUTE_DTYPE),
                              init_train_state(cfg, 0, device="cpu").params)
            caches = init_cache(cfg, b, s, device="cpu")
            if shape.step == "prefill":
                build_prefill_step(cfg)(params, {"tokens": toks}, caches)
            else:
                build_decode_step(cfg)(params, toks[:, :1], caches, s - 1)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,shape_name,multi_pod,shards", [
    ("olmo_1b", "train_4k", False, 256),
    ("olmo_1b", "train_4k", True, 256),        # dp_only: batch not on pod
    ("gemma_7b", "train_4k", True, 512),
    ("h2o_danube_1p8b", "prefill_32k", False, 256),
    ("phi3_medium_14b", "decode_32k", True, 512),
])
def test_run_cell(reduced, arch, shape_name, multi_pod, shards):
    rec = dryrun.run_cell(arch, shape_name, multi_pod=multi_pod, save=False)
    assert _keys(rec) == _reference_keys() | {"derived"}
    mesh = (2, 16, 16) if multi_pod else (16, 16)
    assert rec["mesh"] == list(mesh) and rec["n_devices"] == math.prod(mesh)
    assert rec["memory"]["temp_bytes"] is None
    assert rec["cost"]["bytes_accessed"] is None
    assert rec["t_compile_s"] is None and rec["t_lower_s"] is None
    assert set(rec["derived"]) >= {"argument_bytes", "flops", "collectives"}

    from repro_torch.launch import make_production_mesh
    from repro_torch.sharding import make_rules
    from repro_torch.train import input_specs
    m = make_production_mesh(multi_pod=multi_pod)
    sizes = dict(zip(m.mesh_dim_names, m.shape))
    shape = SMALL[shape_name]
    settings = rec["settings"]
    rules = make_rules(m, batch_divisible=shape.global_batch % (
        sizes.get("pod", 1) * sizes["data"]) == 0,
        seq_sharded_decode=shape.step == "decode",
        dp_only=settings.get("dp_only", False))
    specs = input_specs(TC.get_reduced(arch), shape, rules, settings)
    assert rec["memory"]["argument_bytes"] == sum(
        _spec_bytes(t, sizes) for t in tree_leaves(specs))
    assert rec["derived"]["work_shards"] == shards
    assert rec["cost"]["flops"] == _real_flops(arch, shape_name,
                                               settings) / shards
    params = specs["state"].params if shape.step == "train" else \
        specs["params"]
    assert rec["collectives"]["all-gather"] == sum(
        math.prod(p.shape) * p.element_size() for p in tree_leaves(params)
        if any(p.spec))
    if shape.step == "train":
        assert rec["collectives"]["reduce-scatter"] > 0
        assert rec["memory"]["alias_bytes"] == sum(
            _spec_bytes(t, sizes) for t in tree_leaves(specs["state"]))


def test_multi_pod_halves_accumulation(reduced):
    rec = dryrun.run_cell("gemma_7b", "train_4k", multi_pod=True, save=False)
    assert rec["settings"]["accum"] == TC.train_settings("gemma_7b")[
        "accum"] // 2


def test_cli_writes_each_cell_and_reports(reduced, capsys):
    assert dryrun.main(["--arch", "olmo_1b", "--shape", "train_4k"]) == 0
    out = capsys.readouterr().out
    assert out.count("[ok]") == 2
    for tag in ("singlepod", "multipod"):
        rec = json.loads((reduced / f"olmo_1b__train_4k__{tag}.json")
                         .read_text())
        assert rec["arch"] == "olmo_1b" and rec["shape"] == "train_4k"
    assert dryrun.main(["--arch", "olmo_1b", "--shape", "train_4k",
                        "--singlepod-only", "--skip-existing"]) == 0
    assert "[skip] olmo_1b x train_4k x singlepod" in capsys.readouterr().out


def test_cli_exits_1_on_a_failing_cell(reduced, monkeypatch, capsys):
    run = dryrun.run_cell

    def failing(arch, shape, *, multi_pod, **kw):
        if multi_pod:
            raise RuntimeError("cell broke")
        return run(arch, shape, multi_pod=multi_pod, **kw)

    monkeypatch.setattr(dryrun, "run_cell", failing)
    assert dryrun.main(["--arch", "olmo_1b", "--shape", "train_4k"]) == 1
    out = capsys.readouterr().out
    assert "[ok]   olmo_1b x train_4k x singlepod" in out
    assert "[FAIL] olmo_1b x train_4k x multipod: cell broke" in out
