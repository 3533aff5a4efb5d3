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
shardings are.  ``build_train_step(..., rules=)`` over a ``DeviceMesh`` is
the data-parallel (ZeRO) step that GSPMD makes of the reference's step:
the state rests as ``DTensor`` shards (``shard_state``), each rank takes its
rows of the global batch, gathers the whole param tree once, runs
``accumulate_grads`` on its rows, reduce-scatters the gradients to the
params' placements and updates its shard, with the gradient norm and the
int8 scales reduced over every rank.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..device import DeviceLike
from ..models import (ModelConfig, decode_step, init_cache, init_params,
                      loss_fn, param_logical_axes, prefill)
from ..models.layers import COMPUTE_DTYPE
from ..models.params import param_shapes
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..optim.compress import ef_compress, ef_init
from ..pytree import tree_leaves, tree_map, tree_unflatten
from ..sharding import Rules, use_rules

__all__ = [
    "TrainState", "init_train_state", "build_train_step",
    "build_prefill_step", "build_decode_step", "accumulate_grads",
    "state_shardings", "input_specs", "cache_logical_axes", "shard_state",
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


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """Logical axes mirroring ``init_cache``'s structure."""
    table = {
        "k": ("layers", "act_batch", "cache_seq", "act_kv_heads", "act_hd"),
        "v": ("layers", "act_batch", "cache_seq", "act_kv_heads", "act_hd"),
        "slot_pos": ("layers", None),
        "conv": ("layers", "act_batch", None, "act_dinner"),
        "h": ("layers", "act_batch", "act_dinner", None),
        "xa": ("layers", "act_batch", None),
        "S": ("layers", "act_batch", None, None, None),
        "xc": ("layers", "act_batch", None),
        "xk": ("layers", "act_batch", None, "act_heads", None),
        "xv": ("layers", "act_batch", None, "act_heads", None),
    }
    out = {}
    for kind in cfg.kinds:
        mixer, ffn = kind.split("+")
        names = []
        if mixer in ("attn", "swa"):
            names += ["k", "v", "slot_pos"]
        elif mixer == "mamba":
            names += ["conv", "h"]
        elif mixer == "rwkv":
            names += ["xa", "S", "xc"]
        if ffn == "cmix" and "xc" not in names:
            names.append("xc")
        if cfg.is_encdec:
            names += ["xk", "xv"]
        out[kind] = {n: table[n] for n in names}
    return out


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
# the data-parallel (ZeRO) state and step over a DeviceMesh
# ---------------------------------------------------------------------------
def _device_mesh(rules: Rules):
    """``rules.mesh`` as a ``DeviceMesh`` the step can run on; raises where
    the mesh needs what the step cannot do."""
    mesh = rules.mesh
    if not hasattr(mesh, "get_local_rank"):
        raise TypeError("the sharded step runs over a DeviceMesh "
                        "(launch.mesh_for_devices), not a mesh shape")
    if rules.sizes.get("model", 1) > 1:
        raise ValueError(
            f"mesh {rules.sizes}: a 'model' axis larger than 1 needs "
            "tensor-parallel compute (heads, MLP and experts split over "
            "ranks), which this data-parallel step does not do")
    return mesh


def _param_placements(cfg: ModelConfig, rules: Rules, params) -> Any:
    return _map_axes(lambda ax, p: rules.placements(ax, p.shape),
                     param_logical_axes(cfg), params)


def shard_state(state: TrainState, cfg: ModelConfig,
                rules: Rules) -> TrainState:
    """Each rank's shards of a state that every rank holds whole: params,
    moments and EF residual become ``DTensor``s with the placements of their
    params' specs (no communication); the step count stays a plain tensor."""
    from torch.distributed.tensor import distribute_tensor
    mesh = _device_mesh(rules)
    places = _param_placements(cfg, rules, state.params)

    def put(tree):
        return _map_axes(lambda pl, t: distribute_tensor(
            t, mesh, pl, src_data_rank=None), places, tree)

    return TrainState(params=put(state.params),
                      opt=OptState(put(state.opt.mu), put(state.opt.nu),
                                   state.opt.step),
                      ef=None if state.ef is None else put(state.ef))


def batch_axes(rules: Rules, n: int) -> tuple:
    """The mesh axes a global batch of ``n`` rows is split over, major to
    minor (``act_batch``'s spec; none where they do not divide ``n``)."""
    spec = rules.spec(("act_batch",), (n,))
    axis = spec[0] if spec else None
    return () if axis is None else (axis if isinstance(axis, tuple)
                                    else (axis,))


def _batch_shard(rules: Rules, mesh, n: int) -> tuple:
    """This rank's rows of a global batch of ``n``: (start, stop, the mesh
    axes the batch is split over, their product)."""
    axes = batch_axes(rules, n)
    idx, shards = 0, 1
    for a in axes:         # major to minor, as the reference's global array
        idx = idx * rules.sizes[a] + mesh.get_local_rank(a)
        shards *= rules.sizes[a]
    m = n // shards
    return idx * m, (idx + 1) * m, axes, shards


def _value_and_grad(cfg: ModelConfig, params, batch, remat: str):
    """loss_fn's (loss, metrics) and its gradient for every param leaf (zeros
    for a leaf the loss does not use), all detached."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), cfg, batch,
                                remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def accumulate_grads(cfg: ModelConfig, params, batch, *, accum: int = 1,
                     remat: str = "full",
                     accum_dtype: torch.dtype = torch.float32):
    """The step's gradient and metrics: one pass over ``batch``, or with
    ``accum > 1`` its ``accum`` microbatches (split on the batch axis) in
    turn, the gradients summed in ``accum_dtype`` and averaged, as the
    reference's scanned accumulation.  Returns (grads, metrics): ``loss``,
    and ``tokens`` with ``accum == 1`` only, as there."""
    if accum == 1:
        loss, metrics, grads = _value_and_grad(cfg, params, batch, remat)
        return grads, metrics
    n = next(iter(batch.values())).shape[0]
    if n % accum:
        raise ValueError(f"batch {n} does not split into {accum} "
                         "microbatches")
    m = n // accum
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                           device=p.device), params)
    l_acc = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(params)[0].device)
    for i in range(accum):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        loss, _, g = _value_and_grad(cfg, params, mb, remat)
        g_acc = tree_map(lambda a, b: a + b.to(a.dtype), g_acc, g)
        l_acc = l_acc + loss
    grads = tree_map(lambda g: g / torch.tensor(accum, dtype=g.dtype,
                                                device=g.device), g_acc)
    return grads, {"loss": l_acc / torch.tensor(accum, dtype=torch.float32,
                                                device=l_acc.device)}


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

    With ``rules`` over a ``DeviceMesh`` the step is data-parallel: it takes
    a state of ``DTensor`` shards (``init_train_state(..., rules=)``) and the
    global batch, the same on every rank.  Each rank runs its rows of the
    batch (``act_batch``'s spec) with ``accum`` microbatches on the whole
    gathered param tree; the gradients are summed over the ranks into each
    param's shards (a reduce-scatter) and divided by the number of batch
    shards, the loss averaged and ``tokens`` summed over them.  AdamW and
    the compression run on the shards, their gradient norm and int8 scales
    reduced over every rank (``DTensor``'s reductions), and the per-leaf
    arithmetic is the unsharded step's, so a mesh of one gives its result
    bit for bit.  A mesh whose "model" axis is larger than 1 raises
    ``ValueError``."""

    def train_step(state: TrainState, batch):
        dev = state.opt.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        grads, metrics = accumulate_grads(cfg, state.params, batch,
                                          accum=accum, remat=remat,
                                          accum_dtype=accum_dtype)
        ef = state.ef
        if compress:
            grads, ef = ef_compress(grads, ef)
        params, opt, m2 = adamw_update(grads, state.opt, state.params,
                                       opt_cfg)
        return TrainState(params=params, opt=opt, ef=ef), dict(metrics, **m2)

    if rules is None:
        return train_step
    mesh = _device_mesh(rules)

    def sharded_step(state: TrainState, batch):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        dev = state.opt.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        n = next(iter(batch.values())).shape[0]
        lo, hi, axes, shards = _batch_shard(rules, mesh, n)
        rows = {k: v[lo:hi] for k, v in batch.items()}
        # the whole param tree once, gathered (the reference gathers each
        # layer's weights at use inside its scan: the same values)
        full = tree_map(lambda p: p.full_tensor().detach(), state.params)
        grads, metrics = accumulate_grads(cfg, full, rows, accum=accum,
                                          remat=remat,
                                          accum_dtype=accum_dtype)
        del full
        # per mesh dim: a sum over the ranks that took other rows, or the
        # same value on every rank (a sum over one rank is the value itself)
        partial = [Partial() if a in axes and rules.sizes[a] > 1
                   else Replicate() for a in mesh.mesh_dim_names]

        def summed(t, placements=None):
            d = DTensor.from_local(t, mesh, partial, run_check=False)
            if placements is None:
                return d.full_tensor()
            return d.redistribute(mesh, placements)   # reduce-scatter

        with use_rules(rules), implicit_replication():
            k = torch.tensor(shards, dtype=torch.float32, device=dev)
            grads = tree_map(lambda g, p: summed(g, p.placements)
                             / k.to(g.dtype), grads, state.params)
            metrics = {name: summed(v) / k if name == "loss" else summed(v)
                       for name, v in metrics.items()}
            ef = state.ef
            if compress:
                grads, ef = ef_compress(grads, ef)
            params, opt, m2 = adamw_update(grads, state.opt, state.params,
                                           opt_cfg)
        m2 = {name: v.to_local() if isinstance(v, DTensor) else v
              for name, v in m2.items()}
        return TrainState(params=params, opt=opt, ef=ef), dict(metrics, **m2)

    return sharded_step


def build_prefill_step(cfg: ModelConfig, rules: Optional[Rules] = None):
    def prefill_step(params, batch, caches):
        with use_rules(rules):
            return prefill(params, cfg, batch["tokens"], caches,
                           frontend=batch.get("patches"),
                           frames=batch.get("frames"))
    return prefill_step


def build_decode_step(cfg: ModelConfig, rules: Optional[Rules] = None):
    def serve_step(params, token, caches, pos):
        with use_rules(rules):
            return decode_step(params, cfg, token, caches, pos)
    return serve_step
