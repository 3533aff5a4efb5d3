"""Explicit collectives over the axes of a ("data", "model") or ("pod",
"data", "model") ``DeviceMesh``, on local tensors, each with its backward:
what the sharded train step and sharded serving run where the JAX package
leaves the communication to GSPMD.

A ``Shards`` is one rank's part of a sharded step: the rules, the global
batch (or, in the train step, one microbatch of it), the mesh axes that
batch is split over (``act_batch``'s spec: "data", or ("pod", "data"),
major axis first), this rank's rows of it, and

- ``at_use``: a param leaf (or slice ``idx`` of a stacked one) as a layer
  uses it, its ``embed`` (FSDP) dim all-gathered over every mesh axis its
  placements shard it on ("data", or "pod" and "data", the minor axis
  first) and its tensor-parallel dims (``vocab``, ``mlp``, ``experts``)
  left local; the JAX package's gather-at-use (``_gather_fsdp``), done
  inside the layer loop so that one layer's gathered weights live at a
  time.  Its backward reduce-scatters the gradient back the same way
  (sum), so a layer's weight gradient lands as this rank's shard; over an
  axis the batch does not split every rank runs the same rows, holds the
  whole gradient, and keeps its own slice of it;
- ``local``: the range of an activation dim (``act_heads``,
  ``act_kv_heads``, ``act_dinner``) that this rank computes, or of the
  ring slots (``cache_seq``, split over every axis in the batch-1
  long-context layout) that it holds;
- ``sum`` (all-reduce in f32 forward, the gradient passed unchanged
  backward) and ``enter`` (the identity forward, the gradient summed over
  "model" backward): Megatron's *g* and *f*.  ``sum`` ends a stretch of
  rank-local work whose result every rank then uses alike (an output
  projection's partial sums, or the loss's token sums over the batch
  axes); ``enter`` starts one, on every replicated tensor at the point
  where it feeds rank-local work (an activation, or a weight that rests
  whole on every rank but that a rank uses only in part, such as its
  heads' columns of ``wq``), so that its gradient, a partial sum on each
  rank, comes back whole;
- ``gather``: all-gather over one axis or a tuple of them forward, this
  rank's own slice of the gradient backward (the MoE router's logits,
  the expert choices of a token group that spans batch shards);
- ``max``: all-reduce max, without a gradient (its input detached);
- ``dot``: a product whose contraction is split over "model" (an output
  projection's rows), each rank's part accumulated in f32 and summed
  unrounded, so the sum is rounded to the compute dtype once, as the
  unsharded product rounds it;
- ``lookup``: the vocab-parallel embedding lookup.

Every collective over an axis of size 1 returns its input itself and every
range over one is the whole dim, so on a mesh of one the sharded path runs
the unsharded path's operations on the same tensors.  A collective over a
tuple of axes runs one per axis of size > 1 (the default group where they
are every rank of the job), so no process group beyond the mesh's own is
made.  Each pair is a ``torch.autograd.Function`` over
``torch.distributed``'s functional collectives on the mesh's sub-groups
(``Rules.group``), with its backward written out: the backward that
PyTorch registers for the functional collectives treats an all-reduce's
replicated output as if each rank's gradient were a part of the whole,
which makes every tensor-parallel gradient "model"-size times too large.
Without a gradient being recorded ``enter`` is a plain return.  The
in-place cache writes and the MoE scatter stay plain tensor ops on local
tensors (no ``DTensor`` sharding propagation through the model).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .rules import Rules

__all__ = ["Shards", "as_dtensor", "batch_axes", "product_f32"]


def _wait(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result as a plain tensor."""
    return t.wait() if hasattr(t, "wait") else t


def _all_reduce(t: torch.Tensor, op: str, groups: list) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    for group in groups:
        t = _wait(funcol.all_reduce(t, op, group))
    return t


def _gather_dim(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in their order on the
    group: gathered on dim 0, where every version's functional all-gather
    stacks the ranks, then moved to ``dim`` here."""
    import torch.distributed._functional_collectives as funcol
    out = _wait(funcol.all_gather_tensor(t.contiguous(), 0, group))
    return out if dim == 0 else torch.cat(out.chunk(n, dim=0), dim=dim)


def _scatter_dim(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The sum over the group of ``t``, this rank's slice of it on
    ``dim``."""
    import torch.distributed._functional_collectives as funcol
    out = _wait(funcol.reduce_scatter_tensor(t.movedim(dim, 0).contiguous(),
                                             "sum", 0, group))
    return out.movedim(0, dim)


# Each pair runs its collectives through the ``Shards`` it is given
# (``comm``), which the dry run replaces by one that counts their bytes.
class _Reduce(torch.autograd.Function):
    """Sum over ``groups`` forward; backward the gradient passes unchanged,
    since every rank's addend gets the whole sum's gradient (Megatron's
    *g*)."""

    @staticmethod
    def forward(ctx, t, comm, groups):
        return comm._all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """The identity forward; backward the gradient summed over ``groups``
    in f32 (Megatron's *f*): each rank's gradient of a replicated tensor
    that fed its rank-local work is its part of the whole."""

    @staticmethod
    def forward(ctx, t, comm, groups):
        ctx.comm, ctx.groups = comm, groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        out = ctx.comm._all_reduce(g.float(), "sum", ctx.groups)
        return out.to(g.dtype), None, None


class _Gather(torch.autograd.Function):
    """All-gather of an activation on ``dim`` forward; backward this rank's
    own slice of the gradient, which every rank holds whole."""

    @staticmethod
    def forward(ctx, t, comm, group, n, rank, dim):
        ctx.slice = (dim, rank * t.shape[dim], t.shape[dim])
        return comm._all_gather(t, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.slice), None, None, None, None, None


class _GatherParam(torch.autograd.Function):
    """A param shard all-gathered on ``dim`` forward (FSDP at use);
    backward the gradient reduce-scattered (summed in f32) back to the
    shard, each rank's gradient being its rows' part of the whole."""

    @staticmethod
    def forward(ctx, t, comm, group, n, dim):
        ctx.args = (comm, group, n, dim)
        return comm._all_gather(t, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        comm, group, n, dim = ctx.args
        out = comm._reduce_scatter(g.float(), group, n, dim)
        return out.to(g.dtype), None, None, None, None


class _ProductF32(torch.autograd.Function):
    """``x @ w`` of low-precision operands, accumulated in f32 and not
    rounded; its gradients are those of the product in ``x``'s dtype
    (``torch.mm(..., out_dtype=)`` has no derivative of its own)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                           out_dtype=torch.float32)
            return out.reshape(*x.shape[:-1], w.shape[-1])
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g @ w.T, gw


def product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in f32 and not rounded to ``x``'s dtype.  A
    product of two bf16 values is exact in f32, so on the CPU the f32
    copies' product is what the bf16 GEMM accumulates; on the card
    ``torch.mm(..., out_dtype=)`` keeps the bf16 tensor cores.  Under a
    gradient, ``x`` and ``w`` get the gradients of the product in their
    dtype, on either device."""
    if x.dtype == torch.float32:
        return x @ w
    return _ProductF32.apply(x, w)


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


def _axes(axis) -> tuple:
    """A mesh axis, a tuple of them or ``None`` as a tuple."""
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def batch_axes(rules: Rules, n: int) -> tuple:
    """The mesh axes a batch of ``n`` rows is split over, major to minor
    (``act_batch``'s spec; none where they do not divide ``n``)."""
    spec = rules.spec(("act_batch",), (n,))
    return _axes(spec[0] if spec else None)


class Shards:
    """One rank's part of a sharded train, prefill or decode step over
    ``rules.mesh`` (a ``DeviceMesh`` of axes ("data", "model") or ("pod",
    "data", "model")) for a batch of ``batch`` rows: the global batch
    (serving) or one of the train step's microbatches.  The rows split over
    ``batch_axes`` (``act_batch``'s spec for ``batch`` rows, none where
    they do not divide it), this rank's stretch ``rows`` at its index on
    them, major axis first, as the reference's global array; MoE token
    groups and their capacity are the whole batch's."""

    def __init__(self, rules: Rules, batch: int):
        self.rules = rules
        self.mesh = rules.mesh
        self.batch = batch
        self.batch_axes = batch_axes(rules, batch)
        self.batch_shards = math.prod(self.size(a) for a in self.batch_axes)
        self.batch_index = self.index(self.batch_axes)
        m = batch // self.batch_shards
        self.rows = (self.batch_index * m, (self.batch_index + 1) * m)
        self.fsdp_axes = _axes(rules.table.get("embed"))

    # -- the mesh ---------------------------------------------------------------
    def size(self, axis: str) -> int:
        return self.rules.sizes[axis]

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def index(self, axis) -> int:
        """This rank's index along ``axis``, a mesh axis or a tuple of
        them; over a tuple major axis first, the order of
        ``Rules.placements`` and ``models.params.shard_params``."""
        idx = 0
        for a in _axes(axis):
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
    def _group(self, axis: str):
        return self.rules.group(axis)

    def _all_reduce(self, t, op: str, groups: list) -> torch.Tensor:
        return _all_reduce(t, op, groups)

    def _all_gather(self, t, group, n: int, dim: int) -> torch.Tensor:
        return _gather_dim(t, group, n, dim)

    def _reduce_scatter(self, t, group, n: int, dim: int) -> torch.Tensor:
        return _scatter_dim(t, group, n, dim)

    def _groups(self, axis) -> list:
        """The process groups one reduction over ``axis`` (a mesh axis or a
        tuple of them) runs on, one after another: none for axes of size
        1, the default group where the axes are every rank of the job."""
        live = [a for a in _axes(axis) if self.size(a) > 1]
        if (len(live) > 1 and math.prod(self.size(a) for a in live)
                == self.mesh.size() and self._whole_job()):
            return [self._world()]
        return [self._group(a) for a in live]

    def _whole_job(self) -> bool:
        import torch.distributed as dist
        return self.mesh.size() == dist.get_world_size()

    def _world(self):
        import torch.distributed as dist
        return dist.group.WORLD

    def sum(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axis`` (a mesh axis or a
        tuple of them), added in f32 (an integer ``t`` as it is) and
        returned in ``t``'s dtype; its gradient passes to every rank's
        ``t`` unchanged."""
        groups = self._groups(axis)
        if not groups:
            return t
        if not t.is_floating_point():           # a count: exact, no gradient
            return self._all_reduce(t, "sum", groups)
        return _Reduce.apply(t.float(), self, groups).to(t.dtype)

    def enter(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """``t``, a tensor every rank along ``axis`` holds alike, as the
        input of this rank's part of the work: the identity, whose gradient
        is summed over ``axis``."""
        groups = self._groups(axis)
        if not groups or not (torch.is_grad_enabled() and t.requires_grad):
            return t
        return _Enter.apply(t, self, groups)

    def enter_all(self, p: dict, names) -> dict:
        """``p`` with its weights ``names`` (those it holds) entered: the
        weights that rest whole on every rank of "model" but that a rank
        uses only in part."""
        return dict(p, **{n: self.enter(p[n]) for n in names if n in p})

    def max(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks along ``axis``, with
        no gradient."""
        groups = self._groups(axis)
        if not groups:
            return t.detach()
        return self._all_reduce(t.detach(), "max", groups)

    def dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` where this rank holds a part of the contraction
        (columns of ``x``, the same rows of ``w``): the part accumulated in
        f32, summed over "model" in f32 and rounded to ``x``'s dtype once,
        as the whole product rounds its sum.  (A part rounded first would
        round every element again, which a bf16 recurrence carries on.)"""
        return self.sum(product_f32(x, w), "model").to(x.dtype)

    def gather(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """The ranks' ``t`` along ``axis`` (a mesh axis or a tuple of them)
        concatenated on ``dim``, in the ranks' order on the axes, major
        axis first: over a tuple one gather an axis, the minor axis first.
        The gradient of the result, which every rank holds whole, gives
        each rank its own slice."""
        for a in reversed(_axes(axis)):
            n = self.size(a)
            if n > 1:
                t = _Gather.apply(t, self, self._group(a), n, self.rank(a),
                                  dim)
        return t

    # -- params at use ----------------------------------------------------------
    def at_use(self, leaf, idx: Optional[int] = None) -> torch.Tensor:
        """Param ``leaf`` (slice ``idx`` of its leading "layers" dim) as a
        layer uses it: a ``DTensor``'s local shard with its dim over the
        FSDP axes (``embed``'s) gathered (``gather_param``); a plain tensor
        as it is."""
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(leaf, DTensor):
            return leaf if idx is None else leaf[idx]
        local = leaf.to_local()
        if idx is not None:
            local = local[idx]
        names = tuple(self.mesh.mesh_dim_names)
        axes, dim = [], None
        for a in self.fsdp_axes:
            place = leaf.placements[names.index(a)]
            if isinstance(place, Shard) and self.size(a) > 1:
                axes.append(a)
                dim = place.dim - (0 if idx is None else 1)
        return self.gather_param(local, dim, tuple(axes)) if axes else local

    def gather_param(self, local: torch.Tensor, dim: int,
                     axes: tuple) -> torch.Tensor:
        """A param shard gathered on ``dim`` over ``axes`` (major to
        minor), one axis at a time, the minor first, so the blocks lie in
        the order of the leaf's placements.  Its gradient comes back the
        same way: reduce-scattered over an axis whose ranks took other rows
        of the batch; over one they did not (the batch does not split
        there) each rank computed the whole gradient from the same rows,
        and keeps its own slice (a sum would count it once a rank)."""
        for a in reversed(axes):
            group, n = self._group(a), self.size(a)
            if a in self.batch_axes:
                local = _GatherParam.apply(local, self, group, n, dim)
            else:
                local = _Gather.apply(local, self, group, n, self.rank(a),
                                      dim)
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

