"""Explicit collectives over one axis of a ("data", "model") ``DeviceMesh``,
on local tensors: what sharded serving runs where the JAX package leaves
the communication to GSPMD.

A ``Shards`` is one rank's part of a sharded prefill or decode step: the
rules, the global batch, this rank's rows of it, and

- ``at_use``: a param leaf (or slice ``idx`` of a stacked one) as a layer
  uses it, its ``embed`` (FSDP) dim all-gathered over "data" and its
  tensor-parallel dims (``vocab``, ``mlp``, ``experts``) left local; the
  JAX package's gather-at-use (``_gather_fsdp``), done inside the layer
  loop so that one layer's gathered weights live at a time;
- ``local``: the range of an activation dim (``act_heads``,
  ``act_kv_heads``, ``act_dinner``) that this rank computes, or of the
  ring slots (``cache_seq``, split over ("data", "model") in the batch-1
  long-context layout) that it holds;
- ``sum`` and ``max``: all-reduce (``sum`` in f32) over one mesh axis or
  a tuple of them; ``gather``: all-gather over one axis;
- ``dot``: a product whose contraction is split over "model" (an output
  projection's rows), each rank's part accumulated in f32 and summed
  unrounded, so the sum is rounded to the compute dtype once, as the
  unsharded product rounds it;
- ``lookup``: the vocab-parallel embedding lookup.

Every collective over an axis of size 1 returns its input itself and every
range over one is the whole dim, so on a mesh of one the sharded path runs
the unsharded path's operations on the same tensors.  The collectives are
``torch.distributed``'s functional ones, on the mesh's sub-groups
(``Rules.group``): the
in-place cache writes and the MoE scatter stay plain tensor ops on local
tensors (no ``DTensor`` sharding propagation through the model).
"""
from __future__ import annotations

from typing import Optional

import torch

from .rules import Rules

__all__ = ["Shards", "as_dtensor", "product_f32"]

AXES = ("data", "model")


def _wait(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result as a plain tensor."""
    return t.wait() if hasattr(t, "wait") else t


def product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in f32 and not rounded to ``x``'s dtype.  A
    product of two bf16 values is exact in f32, so on the CPU the f32
    copies' product is what the bf16 GEMM accumulates; on the card
    ``torch.mm(..., out_dtype=)`` keeps the bf16 tensor cores."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def as_dtensor(local: torch.Tensor, rules: Rules, logical, shape):
    """``local`` as this rank's shard of the ``DTensor`` of global
    ``shape`` laid out by the rules' spec of ``logical`` (no copy)."""
    from torch.distributed.tensor import DTensor
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, rules.mesh,
                              rules.placements(logical, shape),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


class Shards:
    """One rank's part of a sharded serving call over ``rules.mesh`` (a
    ``DeviceMesh`` of axes "data" and "model") for a global batch of
    ``batch`` rows."""

    def __init__(self, rules: Rules, batch: int):
        names = tuple(rules.mesh.mesh_dim_names)
        if names != AXES:
            raise ValueError(f"sharded serving runs over a mesh of axes "
                             f"{AXES}, not {names}")
        self.rules = rules
        self.mesh = rules.mesh
        self.batch = batch
        spec = rules.spec(("act_batch",), (batch,))
        axis = spec[0] if spec else None
        if isinstance(axis, tuple) or axis not in (None, "data"):
            raise ValueError(f"act_batch over {axis!r}: sharded serving "
                             "splits the batch over 'data' only")
        self.batch_shards = self.size(axis) if axis else 1
        self.batch_index = self.rank(axis) if axis else 0
        m = batch // self.batch_shards
        self.rows = (self.batch_index * m, (self.batch_index + 1) * m)

    # -- the mesh ---------------------------------------------------------------
    def size(self, axis: str) -> int:
        return self.rules.sizes[axis]

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def index(self, axis) -> int:
        """This rank's index along ``axis``, a mesh axis or a tuple of
        them; over a tuple data-major, the order of ``Rules.placements``
        and ``models.params.shard_params``."""
        idx = 0
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            idx = idx * self.size(a) + self.rank(a)
        return idx

    def local(self, logical: str, n: int) -> tuple:
        """(first, count) of the ``n`` entries of dim ``logical`` that this
        rank computes or holds: its share where the rules split the dim
        over axes whose product divides ``n``, else all of them."""
        axis = self.rules.table.get(logical)
        size = self.rules.axis_size(axis)
        if axis is None or size == 1 or n % size:
            return 0, n
        k = n // size
        return self.index(axis) * k, k

    # -- collectives --------------------------------------------------------------
    def _groups(self, axis) -> list:
        """The process groups one reduction over ``axis`` (a mesh axis or a
        tuple of them) runs on, one after another: none for axes of size
        1, the default group where the axes are every rank of the job."""
        live = [a for a in (axis if isinstance(axis, tuple) else (axis,))
                if self.size(a) > 1]
        if len(live) > 1:
            import torch.distributed as dist
            if self.mesh.size() == dist.get_world_size():
                return [dist.group.WORLD]
        return [self.rules.group(a) for a in live]

    def _all_reduce(self, t: torch.Tensor, op: str, axis) -> torch.Tensor:
        import torch.distributed._functional_collectives as funcol
        for group in self._groups(axis):
            t = _wait(funcol.all_reduce(t, op, group))
        return t

    def sum(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axis`` (a mesh axis or a
        tuple of them), added in f32 and returned in ``t``'s dtype."""
        if not self._groups(axis):
            return t
        return self._all_reduce(t.float(), "sum", axis).to(t.dtype)

    def max(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks along ``axis``."""
        if not self._groups(axis):
            return t
        return self._all_reduce(t, "max", axis)

    def dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` where this rank holds a part of the contraction
        (columns of ``x``, the same rows of ``w``): the part accumulated in
        f32, summed over "model" in f32 and rounded to ``x``'s dtype once,
        as the whole product rounds its sum.  (A part rounded first would
        round every element again, which a bf16 recurrence carries on.)"""
        return self.sum(product_f32(x, w), "model").to(x.dtype)

    def gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ranks' ``t`` along ``axis`` concatenated on ``dim``, in the
        ranks' order on the axis: gathered on dim 0, where every version's
        functional all-gather stacks the ranks, then moved to ``dim`` here."""
        n = self.size(axis)
        if n == 1:
            return t
        import torch.distributed._functional_collectives as funcol
        out = _wait(funcol.all_gather_tensor(t.contiguous(), 0,
                                             self.rules.group(axis)))
        return out if dim == 0 else torch.cat(out.chunk(n, dim=0), dim=dim)

    # -- params at use ----------------------------------------------------------
    def at_use(self, leaf, idx: Optional[int] = None) -> torch.Tensor:
        """Param ``leaf`` (slice ``idx`` of its leading "layers" dim) as a
        layer uses it: a ``DTensor``'s local shard with its dim over "data"
        gathered; a plain tensor as it is."""
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(leaf, DTensor):
            return leaf if idx is None else leaf[idx]
        local = leaf.to_local()
        if idx is not None:
            local = local[idx]
        place = leaf.placements[AXES.index("data")]
        if isinstance(place, Shard):
            local = self.gather(local, "data",
                                place.dim - (0 if idx is None else 1))
        return local

    def lookup(self, table: torch.Tensor, tokens: torch.Tensor
               ) -> torch.Tensor:
        """Rows ``tokens`` of an embedding table whose rows are split over
        "model" (``table`` is this rank's): each rank gives the rows it
        holds and zeros elsewhere, and the sum over "model" is exact, since
        one rank gives each row."""
        n = table.shape[0]
        local = tokens - self.rank("model") * n
        inside = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        return self.sum(torch.where(inside[..., None], rows, 0), "model")

    # -- outputs ----------------------------------------------------------------
    def logits(self, local: torch.Tensor, vocab: int):
        """This rank's logits (its rows, its vocab columns) as the
        ``DTensor`` of the global (batch, seq, ``vocab``) logits laid out
        as (``act_batch``, ``act_seq``, ``act_vocab``)."""
        return as_dtensor(local, self.rules,
                          ("act_batch", "act_seq", "act_vocab"),
                          (self.batch, local.shape[1], vocab))

