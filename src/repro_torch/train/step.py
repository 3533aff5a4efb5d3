"""Step builders: the train step (value and gradient through autograd,
microbatch gradient accumulation, remat policies, optional int8+EF gradient
compression, AdamW) and the prefill / decode steps, with the sharding specs
of every (arch x shape) cell.

A step is a function of its inputs, as the reference's jitted step is: it
returns a new state and leaves the one it was given untouched, so a caller
that retries from the state it holds (``runtime.FaultTolerantLoop``) never
sees one half-updated.

``input_specs`` gives meta-device tensors (shapes and dtypes, no memory),
each with its spec (``Rules.spec``) as the attribute ``spec``, for every
input of a cell: what the reference's ``ShapeDtypeStruct``s with their
shardings are.  ``build_train_step(..., rules=)`` over a ("data",
"model") or ("pod", "data", "model") ``DeviceMesh`` shards the step as
GSPMD shards the reference's: the state rests as ``DTensor`` shards
(``shard_state``), the global batch splits into ``accum`` microbatches,
and each rank runs its rows of each (``act_batch``'s split), the
microbatch's loss and MoE token groups the whole microbatch's.  Under
``dp_only`` rules it is data-parallel (ZeRO): a rank gathers the whole
param tree once, runs ``accumulate_grads`` on its rows and reduce-scatters
the gradients to the params' placements.  Under the tensor-parallel rules
(``make_rules(mesh)``) a rank runs ``loss_fn`` with ``shards`` on its param
shards: each layer's weights gathered over the FSDP axes at use, heads,
MLP, experts, mamba's inner dim and the vocab split over "model", the
collectives explicit with their backwards (``sharding.collectives``), so
that each gradient arrives as the rank's shard.  Either way the update
runs on the shards, with the gradient norm and the int8 scales reduced
over every rank.  ``build_prefill_step`` and ``build_decode_step`` with
``rules`` over such a ``DeviceMesh`` serve sharded: each rank runs its rows
of the global batch on its param and cache shards, the tensor- and
expert-parallel collectives explicit in ``models.lm``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import obs
from ..device import DeviceLike
from ..models import (ModelConfig, decode_step, init_cache, init_params,
                      loss_fn, param_logical_axes, prefill)
from ..models.layers import COMPUTE_DTYPE
from ..models.lm import cache_logical_axes
from ..models.params import param_placements, param_shapes
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..optim.compress import ef_compress, ef_init
from ..pytree import tree_leaves, tree_map, tree_unflatten
from ..sharding import Rules, use_rules

__all__ = [
    "TrainState", "init_train_state", "build_train_step",
    "build_prefill_step", "build_decode_step", "accumulate_grads",
    "state_shardings", "input_specs", "cache_logical_axes", "shard_state",
    "sharded_grads",
]


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    ef: Optional[dict]      # error-feedback residual (compression) or None


def init_train_state(cfg: ModelConfig, seed: int = 0, *,
                     compress: bool = False,
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     device: DeviceLike = None,
                     rules: Optional[Rules] = None) -> TrainState:
    """Fresh params from ``seed``, zero moments and step 0 on ``device``
    (default: the card); an EF residual too with ``compress``.  With
    ``rules`` over a ``DeviceMesh``, each rank keeps its shards
    (``shard_state``)."""
    params = init_params(cfg, seed, device=device)
    state = TrainState(params=params, opt=adamw_init(params, opt_cfg),
                       ef=ef_init(params) if compress else None)
    return state if rules is None else shard_state(state, cfg, rules)


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------
def _map_axes(fn, axes, tree):
    """``fn(logical_axes, leaf)`` over a dict tree whose axes tree holds a
    tuple of logical names in each leaf's place."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, axes[k], tree[k]) for k in tree}
    return fn(axes, tree)


def _struct(shape, dtype: torch.dtype, spec: tuple) -> torch.Tensor:
    """A meta-device tensor (no memory) carrying its spec as ``.spec``."""
    out = torch.empty(tuple(shape), dtype=dtype, device="meta")
    out.spec = spec
    return out


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def state_shardings(cfg: ModelConfig, rules: Rules, *,
                    compress: bool = False, dtype=torch.float32,
                    mu_dtype=torch.float32, nu_dtype=torch.float32
                    ) -> TrainState:
    """Meta-device stand-ins, each with its ``spec``, for the full
    TrainState."""
    params = _map_axes(lambda ax, s: _struct(s.shape, _dtype(dtype),
                                             rules.spec(ax, s.shape)),
                       param_logical_axes(cfg), param_shapes(cfg))
    cast = lambda tree, dt: tree_map(
        lambda s: _struct(s.shape, _dtype(dt), s.spec), tree)
    opt = OptState(mu=cast(params, mu_dtype), nu=cast(params, nu_dtype),
                   step=_struct((), torch.int32, ()))
    return TrainState(params=params, opt=opt,
                      ef=cast(params, torch.float32) if compress else None)


def _batch_struct(cfg: ModelConfig, seq: int, batch: int, rules: Rules,
                  *, with_labels: bool) -> dict:
    bsp = rules.spec(("act_batch", None), (batch, seq))
    text = seq - cfg.frontend_tokens
    out = {"tokens": _struct((batch, text), torch.int32, bsp)}
    if with_labels:
        # labels align with text positions; loss_fn pads frontend positions
        out["labels"] = _struct((batch, text), torch.int32, bsp)
    if cfg.frontend_tokens:
        shp = (batch, cfg.frontend_tokens, cfg.d_model)
        out["patches"] = _struct(shp, COMPUTE_DTYPE,
                                 rules.spec(("act_batch", None, None), shp))
    if cfg.is_encdec:
        shp = (batch, cfg.encoder_seq, cfg.d_model)
        out["frames"] = _struct(shp, COMPUTE_DTYPE,
                                rules.spec(("act_batch", None, None), shp))
    return out


def _cache_struct(cfg: ModelConfig, batch: int, max_seq: int,
                  rules: Rules) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():       # init_cache's shapes, nothing allocated
        shapes = init_cache(cfg, batch, max_seq, device="cpu")
    return _map_axes(lambda ax, s: _struct(s.shape, s.dtype,
                                           rules.spec(ax, s.shape)),
                     cache_logical_axes(cfg), shapes)


def input_specs(cfg: ModelConfig, shape, rules: Rules,
                settings: Optional[dict] = None) -> dict:
    """Meta-device stand-ins, each with its ``spec``, for one (arch x shape)
    cell.

    shape.step selects the computation:
      train   -> {"state": TrainState, "batch": {...}}
      prefill -> {"params", "batch", "caches"}
      decode  -> {"params", "token", "caches", "pos"}
    """
    settings = settings or {}
    b, s = shape.global_batch, shape.seq_len
    if shape.step == "train":
        state = state_shardings(
            cfg, rules, dtype=settings.get("param_dtype", "float32"),
            mu_dtype=settings.get("mu_dtype", "float32"),
            nu_dtype=settings.get("nu_dtype", "float32"))
        batch = _batch_struct(cfg, s, b, rules, with_labels=True)
        return {"state": state, "batch": batch}
    if shape.step == "prefill":
        state = state_shardings(cfg, rules, dtype=COMPUTE_DTYPE)
        batch = _batch_struct(cfg, s, b, rules, with_labels=False)
        caches = _cache_struct(cfg, b, s, rules)
        return {"params": state.params, "batch": batch, "caches": caches}
    if shape.step == "decode":
        state = state_shardings(cfg, rules, dtype=COMPUTE_DTYPE)
        token = _struct((b, 1), torch.int32, rules.spec(("act_batch", None)))
        caches = _cache_struct(cfg, b, s, rules)
        pos = _struct((), torch.int32, ())
        return {"params": state.params, "token": token, "caches": caches,
                "pos": pos}
    raise ValueError(shape.step)


# ---------------------------------------------------------------------------
# the sharded state and steps over a DeviceMesh
# ---------------------------------------------------------------------------
def _device_mesh(rules: Rules):
    """``rules.mesh`` as a ``DeviceMesh`` the step can run on."""
    mesh = rules.mesh
    if not hasattr(mesh, "get_local_rank"):
        raise TypeError("the sharded step runs over a DeviceMesh "
                        "(launch.mesh_for_devices), not a mesh shape")
    return mesh


def shard_state(state: TrainState, cfg: ModelConfig,
                rules: Rules) -> TrainState:
    """Each rank's shards of a state that every rank holds whole: params,
    moments and EF residual become ``DTensor``s with the placements of their
    params' specs (no communication); the step count stays a plain tensor."""
    from torch.distributed.tensor import distribute_tensor
    mesh = _device_mesh(rules)
    places = param_placements(cfg, rules, state.params)

    def put(tree):
        return _map_axes(lambda pl, t: distribute_tensor(
            t, mesh, pl, src_data_rank=None), places, tree)

    return TrainState(params=put(state.params),
                      opt=OptState(put(state.opt.mu), put(state.opt.nu),
                                   state.opt.step),
                      ef=None if state.ef is None else put(state.ef))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard; a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _value_and_grad(cfg: ModelConfig, params, batch, remat: str,
                    shards=None):
    """loss_fn's (loss, metrics) and its gradient for every param leaf (zeros
    for a leaf the loss does not use), all detached; with ``shards``, each
    ``DTensor`` leaf's gradient as its local shard."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad(), obs.span("train.forward"):
        loss, metrics = loss_fn(tree_unflatten(params, leaves), cfg, batch,
                                remat=remat, shards=shards)
    with obs.span("train.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [_local(torch.zeros_like(p) if g is None else g)
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def accumulate_grads(cfg: ModelConfig, params, batch, *, accum: int = 1,
                     remat: str = "full",
                     accum_dtype: torch.dtype = torch.float32, shards=None):
    """The step's gradient and metrics: one pass over ``batch``, or with
    ``accum > 1`` its ``accum`` microbatches (split on the batch axis) in
    turn, the gradients summed in ``accum_dtype`` and averaged, as the
    reference's scanned accumulation.  Returns (grads, metrics): ``loss``,
    and ``tokens`` with ``accum == 1`` only, as there.  With ``shards``
    (``sharding.collectives.Shards`` of one microbatch, ``shards.batch``
    rows), one rank's part of the sharded step: ``batch`` is the global
    batch, each microbatch runs this rank's rows of it (``shards.rows``)
    with the whole microbatch's loss, ``params`` are its ``DTensor``
    shards, and each gradient is its local shard of the rank's part of the
    gradient (summed over the FSDP axes where the leaf is gathered there at
    use)."""
    n = next(iter(batch.values())).shape[0]
    if n % accum:
        raise ValueError(f"batch {n} does not split into {accum} "
                         "microbatches")
    m = n // accum
    lo, hi = (0, m) if shards is None else shards.rows

    def micro(i: int) -> dict:
        return {k: v[i * m + lo:i * m + hi] for k, v in batch.items()}

    if accum == 1:
        loss, metrics, grads = _value_and_grad(cfg, params, micro(0), remat,
                                               shards)
        return grads, metrics
    g_acc = tree_map(lambda p: torch.zeros(_local(p).shape,
                                           dtype=accum_dtype,
                                           device=p.device), params)
    l_acc = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(params)[0].device)
    for i in range(accum):
        loss, _, g = _value_and_grad(cfg, params, micro(i), remat, shards)
        # in place: the sums (and the quotients below) are the same, and
        # no second copy of the gradients lives beside the first
        tree_map(lambda a, b: a.add_(b.to(a.dtype)), g_acc, g)
        del g
        l_acc = l_acc + loss
    grads = tree_map(lambda g: g.div_(torch.tensor(accum, dtype=g.dtype,
                                                   device=g.device)), g_acc)
    return grads, {"loss": l_acc / torch.tensor(accum, dtype=torch.float32,
                                                device=l_acc.device)}


def _spanned(name: str, step):
    """``step`` inside the span ``name`` (``obs``)."""
    @functools.wraps(step)
    def spanned(*args, **kw):
        with obs.span(name):
            return step(*args, **kw)
    return spanned


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    *,
    rules: Optional[Rules] = None,
    accum: int = 1,
    compress: bool = False,
    remat: str = "full",
    accum_dtype: torch.dtype = torch.float32,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is a dict of arrays or tensors (``tokens``, ``labels`` and, per
    configuration, ``patches`` or ``frames``), moved to the state's device.
    ``accum > 1`` splits it into microbatches run in turn; ``accum_dtype``
    holds their summed gradients.  Metrics (0-d tensors on the device):
    ``loss``, ``tokens`` (accum 1 only), ``grad_norm`` and ``lr``.

    With ``rules`` over a ("data", "model") or ("pod", "data", "model")
    ``DeviceMesh`` the step is sharded: it takes a state of ``DTensor``
    shards laid out by the rules (``init_train_state(..., rules=)``) and
    the global batch, the same on every rank, and computes the reference's
    step (GSPMD's semantics).  The global batch splits into ``accum``
    microbatches, microbatch ``i`` being global rows [i B/accum, (i+1)
    B/accum); a rank runs its rows of each, split over the batch's mesh
    axes (``act_batch``'s spec for B/accum rows, major axis first; all of
    them on every rank where the axes do not divide it).  Each
    microbatch's loss is its summed token loss over its label count, both
    summed over the batch axes, and its MoE token groups and capacity are
    the whole microbatch's (a group that spans ranks ranks its dispatches
    on the gathered expert choices), so with uneven label counts or
    spanning groups the step is still the unsharded step with the same
    ``accum``.

    - ``dp_only`` rules: data-parallel, the batch over ("data", "model")
      (on a multi-pod mesh every pod runs the same rows, and "pod" carries
      only FSDP, as the reference's rules say).  A rank gathers the whole
      param tree once and runs ``accumulate_grads`` on it with a
      ``Shards`` that only sums the loss; the gradients, each the rank's
      rows' part of the whole, are summed over the batch axes into each
      param's shards (a reduce-scatter).
    - the tensor-parallel rules (``make_rules(mesh)``): a rank runs
      ``loss_fn`` with ``shards`` (``sharding.collectives.Shards``) on its
      param shards.  Inside the layer loop each layer's weights are
      gathered over the FSDP axes ("data", or "pod" and "data") at use,
      their "model" shards left local; heads (attention, whisper's
      cross-attention, rwkv6's time mix), the MLP's and channel mix's
      hidden dim, the experts, mamba's inner dim and the vocab are split
      over "model" where "model" divides them, with the tensor- and
      expert-parallel collectives explicit and each with its backward.  A
      weight gathered over the FSDP axes gets its gradient reduce-scattered
      back over them; a weight that rests replicated over "model" and feeds
      rank-local work has its gradient summed over "model" there
      (``Shards.enter``), and one used alike on every rank (norm scales)
      holds the whole gradient already, so no leaf is summed over "model"
      again.  A leaf replicated over a batch axis has its gradient
      all-reduced over it after the microbatches (``sharded_grads``).

    The loss (and, with ``accum == 1``, ``tokens``) is the reference's,
    the same on every rank.  AdamW and the compression run on the shards,
    their gradient norm and int8 scales global over every rank
    (``DTensor``'s reductions: a leaf replicated over an axis counts once),
    and the per-leaf arithmetic is the unsharded step's, so a mesh of one
    gives its result bit for bit."""

    def train_step(state: TrainState, batch):
        dev = state.opt.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        grads, metrics = accumulate_grads(cfg, state.params, batch,
                                          accum=accum, remat=remat,
                                          accum_dtype=accum_dtype)
        with obs.span("train.update"):
            ef = state.ef
            if compress:
                grads, ef = ef_compress(grads, ef)
            params, opt, m2 = adamw_update(grads, state.opt, state.params,
                                           opt_cfg, donate_grads=True)
        return TrainState(params=params, opt=opt, ef=ef), dict(metrics, **m2)

    if rules is None:
        return _spanned("step.train", train_step)
    mesh = _device_mesh(rules)

    def update(state: TrainState, grads, metrics):
        """The compression and AdamW on the shards, from ``grads``
        (``DTensor``s at the params' placements)."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        with use_rules(rules), implicit_replication(), \
                obs.span("train.update"):
            ef = state.ef
            if compress:
                grads, ef = ef_compress(grads, ef)
            params, opt, m2 = adamw_update(grads, state.opt, state.params,
                                           opt_cfg, donate_grads=True)
        m2 = {name: v.to_local() if isinstance(v, DTensor) else v
              for name, v in m2.items()}
        return TrainState(params=params, opt=opt, ef=ef), dict(metrics, **m2)

    def dp_step(state: TrainState, batch):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.distributed.tensor.experimental import (
            implicit_replication)

        from ..sharding.collectives import Shards
        dev = state.opt.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        n = next(iter(batch.values())).shape[0]
        # the whole param tree once, gathered (the reference gathers each
        # layer's weights at use inside its scan: the same values); on it
        # a Shards only sums the loss over the batch axes
        full = tree_map(lambda p: p.full_tensor().detach(), state.params)
        shards = Shards(rules, n // accum)
        grads, metrics = accumulate_grads(cfg, full, batch, accum=accum,
                                          remat=remat,
                                          accum_dtype=accum_dtype,
                                          shards=shards)
        del full
        # per mesh dim: a sum over the ranks that took other rows, or the
        # same value on every rank (a sum over one rank is the value itself)
        partial = [Partial() if a in shards.batch_axes
                   and rules.sizes[a] > 1 else Replicate()
                   for a in mesh.mesh_dim_names]
        with use_rules(rules), implicit_replication():
            grads = tree_map(lambda g, p: DTensor.from_local(
                g, mesh, partial, run_check=False).redistribute(
                    mesh, p.placements), grads, state.params)
        return update(state, grads, metrics)

    def tp_step(state: TrainState, batch):
        dev = state.opt.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        grads, metrics = sharded_grads(cfg, state.params, batch, rules,
                                       accum=accum, remat=remat,
                                       accum_dtype=accum_dtype)
        return update(state, grads, metrics)

    return _spanned("step.train",
                    dp_step if rules.table.get("_gather_tp") else tp_step)


def sharded_grads(cfg: ModelConfig, params, batch, rules: Rules, *,
                  accum: int = 1, remat: str = "full",
                  accum_dtype: torch.dtype = torch.float32):
    """The tensor-parallel step's gradient and metrics on this rank:
    ``params`` its ``DTensor`` shards under ``rules`` (not ``dp_only``),
    ``batch`` the global batch.  The rank runs its rows of each of the
    ``accum`` microbatches through ``loss_fn`` with ``shards``
    (``sharding.collectives.Shards`` of one microbatch: the whole
    microbatch's loss and MoE token groups); each gradient comes back as
    its shard of the rank's part of the whole, a leaf gathered over the
    FSDP axes at use summed over them by the gather's backward and a leaf
    replicated over a batch axis all-reduced over it here.  Returns
    (grads, ``DTensor``s at the params' placements; metrics, the
    reference's, the same on every rank)."""
    from torch.distributed.tensor import DTensor, Shard

    from ..sharding.collectives import Shards
    mesh = _device_mesh(rules)
    _check_shards(params, param_logical_axes(cfg), rules, "params")
    n = next(iter(batch.values())).shape[0]
    shards = Shards(rules, n // accum)
    grads, metrics = accumulate_grads(cfg, params, batch, accum=accum,
                                      remat=remat, accum_dtype=accum_dtype,
                                      shards=shards)
    names = tuple(mesh.mesh_dim_names)

    def whole(g, p):
        # a leaf gathered over an axis at use had its gradient summed
        # there by the gather's backward
        over = tuple(a for a in shards.batch_axes if not isinstance(
            p.placements[names.index(a)], Shard))
        groups = shards._groups(over)
        if groups:
            g = shards._all_reduce(g.float(), "sum", groups).to(g.dtype)
        return DTensor.from_local(g, mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())

    return tree_map(whole, grads, params), metrics


# ---------------------------------------------------------------------------
# serving steps, unsharded or over a (data, model) DeviceMesh
# ---------------------------------------------------------------------------
def _serving_mesh(rules: Rules):
    """``rules.mesh`` as a ``DeviceMesh`` the serving steps run on."""
    mesh = rules.mesh
    if not hasattr(mesh, "get_local_rank"):
        raise TypeError("sharded serving runs over a DeviceMesh "
                        "(launch.mesh_for_devices), not a mesh shape")
    return mesh


def _check_shards(tree, axes, rules: Rules, what: str) -> None:
    """Every leaf of ``tree`` is a ``DTensor`` laid out as the rules give
    (``input_specs``' spec), with the local shape of that spec."""
    from torch.distributed.tensor import DTensor

    def one(ax, t):
        if not isinstance(t, DTensor):
            raise TypeError(f"{what}: a plain tensor where a DTensor shard "
                            f"is expected (axes {ax})")
        spec = rules.spec(ax, t.shape)
        want = rules.local_shape(t.shape, spec)
        if (tuple(t.to_local().shape) != want
                or tuple(t.placements) != rules.placements(ax, t.shape)):
            raise ValueError(f"{what}: shard {tuple(t.to_local().shape)} "
                             f"{t.placements} of {tuple(t.shape)}, the "
                             f"rules give {want} for spec {spec}")
    _map_axes(one, axes, tree)


def _serving_shards(cfg: ModelConfig, rules: Rules, params, caches,
                    batch: int):
    from ..sharding.collectives import Shards
    _check_shards(params, param_logical_axes(cfg), rules, "params")
    _check_shards(caches, cache_logical_axes(cfg), rules, "caches")
    return Shards(rules, batch)


def build_prefill_step(cfg: ModelConfig, rules: Optional[Rules] = None):
    """Returns ``prefill_step(params, batch, caches) -> (logits, caches)``.

    With ``rules`` over a ("data", "model") or ("pod", "data", "model")
    ``DeviceMesh`` the step is sharded: it takes params and caches as
    ``DTensor`` shards (``models.params.shard_params``, ``init_cache(...,
    rules=)``) and the global batch, the same on every rank; each rank runs
    its rows (``act_batch``) on its shards, the collectives explicit
    (``models.lm``), and the logits come back as the ``DTensor`` of the
    global ones.  Every configuration serves on a mesh of any sizes.  Under
    ``make_rules(mesh)`` the batch and the params' FSDP dim are split over
    "data" (or ("pod", "data"), pod-major); over "model" the
    query and kv heads (attention, whisper's cross-attention and its
    ``xk``/``xv`` caches, rwkv6's time mix), the MLP's and the channel
    mix's hidden dim, the experts, mamba's inner dim (and its ``conv``/
    ``h`` caches) and the vocab, where "model" divides them; the KV caches
    by kv heads, or by ``head_dim`` where the kv heads do not divide.
    Under the batch-1 long-context rules (``make_rules(mesh,
    batch_divisible=False, seq_sharded_decode=True)``) every rank takes
    the whole batch, the KV caches are split by ring slots over every
    mesh axis and decode combines the ranks' softmax over them; the rest
    splits over "model" as above."""
    if rules is None:
        def prefill_step(params, batch, caches):
            return prefill(params, cfg, batch["tokens"], caches,
                           frontend=batch.get("patches"),
                           frames=batch.get("frames"))
        return _spanned("step.prefill", prefill_step)
    _serving_mesh(rules)

    def sharded_prefill(params, batch, caches):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        shards = _serving_shards(cfg, rules, params, caches,
                                 batch["tokens"].shape[0])
        lo, hi = shards.rows
        rows = {k: v[lo:hi] for k, v in batch.items()}
        return prefill(params, cfg, rows["tokens"], caches,
                       frontend=rows.get("patches"), frames=rows.get("frames"),
                       shards=shards)
    return _spanned("step.prefill", sharded_prefill)


def build_decode_step(cfg: ModelConfig, rules: Optional[Rules] = None):
    """Returns ``serve_step(params, token, caches, pos) -> (logits,
    caches)``; with ``rules`` over a ``DeviceMesh``, sharded as
    ``build_prefill_step``'s step: ``token`` (B, 1) is the global batch's."""
    if rules is None:
        def serve_step(params, token, caches, pos):
            return decode_step(params, cfg, token, caches, pos)
        return _spanned("step.decode", serve_step)
    _serving_mesh(rules)

    def sharded_decode(params, token, caches, pos):
        token = torch.as_tensor(token)
        shards = _serving_shards(cfg, rules, params, caches, token.shape[0])
        lo, hi = shards.rows
        return decode_step(params, cfg, token[lo:hi], caches, pos,
                           shards=shards)
    return _spanned("step.decode", sharded_decode)
