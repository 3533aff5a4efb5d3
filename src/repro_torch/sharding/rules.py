"""Logical-axis -> mesh-axis sharding rules with divisibility fallback.

Every tensor dimension in the model substrate carries a *logical* name; a
``Rules`` object maps logical names to mesh axes and gives each tensor its
spec: a tuple with one entry per dim (a mesh axis name, a tuple of them, or
``None``), trailing ``None``s trimmed, equal to ``tuple(PartitionSpec)`` of
the JAX package's rules on a mesh of the same shape.  A logical dim whose
size does not divide the mesh-axis size is *replicated* (the axis is
dropped), and a mesh axis appears at most once in a spec.

Default mapping (1000+ node posture):

  params:      vocab/heads/kv_heads/mlp/experts -> "model" (TP/EP)
               embed/ffn-in (the non-TP big dim) -> "data"  (FSDP / ZeRO-3)
  activations: batch -> ("pod", "data") (DP; pod composes as extra DP)
               heads/mlp/experts/vocab -> "model" (TP)
  decode:      cache_seq -> "model" (KV-parallel decode); for batch=1
               long-context it becomes ("data", "model") so 500k caches
               spread over all chips.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or the
device-free ``launch.mesh.MeshShape``; the rules read only its axis names
and sizes (``Rules.sizes``).  On a ``DeviceMesh``, ``Rules.placements``
turns a spec into ``DTensor`` placements.

Rules are *installed* with ``use_rules`` (a context manager); ``shard(x,
*logical_dims)`` is a no-op outside a rules context.  Inside one, a plain
tensor comes back unchanged (eager PyTorch has no compiler to take a layout
constraint, and a constraint changes layout, not values) and a ``DTensor``
is redistributed to the spec's placements.  The model code calls no
``shard``: the data-parallel train step (``train.build_train_step(...,
rules=)``) and sharded serving (``train.build_prefill_step(..., rules=)``,
over ``collectives.Shards``) make their collectives explicit, on the local
shards whose shapes ``Rules.local_shape`` gives.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Sequence, Union

import torch

__all__ = ["Rules", "make_rules", "mesh_spec", "shard", "use_rules",
           "current_rules", "mesh_sizes"]

AxisName = Union[str, tuple, None]


def mesh_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` or a ``MeshShape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Any    # DeviceMesh | launch.mesh.MeshShape
    table: dict  # logical name -> mesh axis (str | tuple | None)

    @property
    def sizes(self) -> dict:
        return mesh_sizes(self.mesh)

    def axis_size(self, axis: AxisName) -> int:
        if axis is None:
            return 1
        sizes = self.sizes
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= sizes[a]
            return n
        return sizes[axis]

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> tuple:
        """The spec for logical dims; drops axes that don't divide the dim
        size (when ``shape`` is given) or that repeat in the spec."""
        used: set = set()
        out = []
        for i, name in enumerate(logical):
            axis = self.table.get(name) if name else None
            if axis is not None and shape is not None:
                if shape[i] % self.axis_size(axis) != 0:
                    axis = None
            # one mesh axis may appear only once in a spec
            flat = axis if isinstance(axis, tuple) else (axis,)
            if axis is not None and any(a in used for a in flat):
                axis = None
            if axis is not None:
                used.update(flat)
            out.append(axis)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def local_shape(self, shape: Sequence[int], spec: tuple) -> tuple:
        """The shape of one rank's shard of a ``shape``-shaped tensor laid
        out by ``spec`` (every split of a spec divides its dim)."""
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        return tuple(n // self.axis_size(a) for n, a in zip(shape, spec))

    def group(self, axis: str):
        """The process group of this rank's ranks along mesh axis ``axis``
        (a ``DeviceMesh`` only)."""
        return self.mesh.get_group(axis)

    def placements(self, logical: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None) -> tuple:
        """``DTensor`` placements of ``spec(logical, shape)``: per mesh dim,
        ``Shard(i)`` where tensor dim ``i``'s axis is or holds that mesh
        dim, else ``Replicate()``.  A tuple axis lists its mesh dims in mesh
        order (``make_rules`` asserts it), so ``DTensor``'s order of the
        shards on one tensor dim is the JAX package's."""
        from torch.distributed.tensor import Replicate, Shard
        dim_of = {}
        for i, axis in enumerate(self.spec(logical, shape)):
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    dim_of[a] = i
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in self.mesh.mesh_dim_names)


def make_rules(
    mesh,
    *,
    batch_divisible: bool = True,
    seq_sharded_decode: bool = False,
    seq_parallel: bool = False,
    dp_only: bool = False,
) -> Rules:
    """Build the rule table for a mesh.

    batch_divisible=False (e.g. long_500k, global batch 1): the batch axis is
    replicated and the decode cache_seq dim spreads over (data, model).
    seq_parallel=True (Megatron-SP style): activations shard their sequence
    dim over "model"; because one mesh axis appears at most once per spec,
    downstream head/mlp TP annotations dedup away automatically and weights
    are all-gathered per layer (ZeRO-3 comm pattern).
    dp_only=True (pure ZeRO-DP, the <2B-model mapping): the batch shards
    over EVERY mesh axis, activations are never tensor-sharded, and weights
    (2D-sharded at rest) are fully all-gathered at use.  Replaces per-layer
    activation-sized TP all-reduces with weight-sized all-gathers.
    """
    has_pod = "pod" in mesh_sizes(mesh)
    dp = ("pod", "data") if has_pod else ("data",)
    # dp_only batch spans (data, model) — NOT pod: the global batch (256)
    # must divide the DP degree, and pod still carries FSDP of the params
    full = ("data", "model")
    table = {
        # --- parameter dims ---
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "embed": dp,          # FSDP shard of the non-TP dim; multi-pod
                              # composes (pod, data) = 32-way ZeRO-3
        "embed2": None,       # second embed dim (e.g. attn out proj input)
        "head_dim": None,
        "layers": None,
        "conv": None,
        "state": None,
        # --- activation dims ---
        "act_batch": (full if dp_only else dp) if batch_divisible else None,
        "act_flat": (full if dp_only else dp) if batch_divisible else None,
        "act_seq": "model" if seq_parallel else None,
        "act_embed": None,
        "act_heads": None if dp_only else "model",
        "act_kv_heads": None if dp_only else "model",
        "act_mlp": None if dp_only else "model",
        "act_experts": None if dp_only else "model",
        "act_vocab": None if dp_only else "model",
        "act_dinner": None if dp_only else "model",
        "act_hd": None if dp_only else "model",  # decode-cache head_dim
        # --- decode cache dims ---
        # batch-divisible decode shards caches on kv_heads/head_dim (keeps
        # the per-token cache write shard-local); long-context batch-1
        # decode spreads cache_seq over every axis instead.
        "cache_seq": (
            (("data", "model") if has_pod is False else ("pod", "data", "model"))
            if (seq_sharded_decode and not batch_divisible)
            else None
        ),
        # weight gather-at-use policy: gather every dim (the JAX package's
        # models/lm.py _gather_fsdp)
        "_gather_tp": dp_only,
    }
    # normalize tuple-of-one
    for k, v in table.items():
        if isinstance(v, tuple) and len(v) == 1:
            table[k] = v[0]
    order = {a: i for i, a in enumerate(mesh.mesh_dim_names)}
    for k, v in table.items():
        # DTensor orders the shards of one tensor dim by mesh dim, JAX by
        # the tuple: they agree only when the tuple is in mesh order
        assert not isinstance(v, tuple) or (
            [order[a] for a in v] == sorted(order[a] for a in v)), (k, v)
    return Rules(mesh=mesh, table=table)


def mesh_spec(rules: Rules, logical: Sequence[Optional[str]],
              shape: Optional[Sequence[int]] = None) -> tuple:
    return rules.spec(logical, shape)


_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_rules",
                                                      default=None)


def current_rules() -> Optional[Rules]:
    return _CTX.get()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    tok = _CTX.set(rules)
    try:
        yield rules
    finally:
        _CTX.reset(tok)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Annotate a tensor with its logical dims: a no-op without rules or on
    a plain tensor; a ``DTensor`` is redistributed to the spec's
    placements."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, rules.placements(logical, x.shape))
