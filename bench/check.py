"""Whether what the timed path produced is correct: the reference
(``bench/reference``, plain float32 with TF32 off) recomputes it from the
same seed's weights and inputs, once the window has closed and the
program's state is freed, and each number compared is held to its limit
(``bench/limits/<workload>.json``).

Serving (prefill and decode), over the batches or steps ``kept``
(``_Tally.numbers`` reads more than the limits compare; calibration
prints them all):

- ``cache_med``: per layer, for keys and values, and per prefill batch
  (decode: its whole cache), the median over tokens of each token's
  distance from the reference over the reference's norm, the worst of
  them;
- ``cache_q75``: the same with the 75th percentile over tokens;
- ``logit_med``: the median over every compared row of the same for the
  served logits;
- ``logit_least``: per prefill batch (decode: per compared step) the
  least of its rows' logit distances, the worst batch's;
- ``gap_mean``: the mean over served tokens of the gap by which a served
  greedy token's reference logit lies below the reference's best.

Prefill's caches are judged batch by batch and its logits by each batch's
best row, so that a fault confined to one shape (the longest rows, say)
or to the later half of each row is not outvoted by the batches it
spares.

Medians, a quartile, a least row and a mean over thousands of tokens,
because the program's bf16 routing flips a near-tied expert for a few per
cent of tokens in each MoE layer: those tokens differ from the float32
reference by far more than rounding, so a widest gap, a norm over all
tokens, or the median of a batch's few rows reads as high as the
control's.

Training, over the set-up steps that the window's own step ran:

- ``loss_gap``: the largest gap of a step's loss from the reference's,
  over the reference's (read, not compared: neither the control nor a
  fault reads ten times what sound runs read);
- ``grad_gap``: the worst leaf's gap between the norm of the first
  gradient as the optimizer got it and the reference's, over the larger
  of that leaf's reference norm and the median leaf's;
- ``change_gap``: the same for each leaf's change over the set-up steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).

The serving control (``control=True``) is the reference itself computed
with every product's operands in float8 (``reference.transformer.fp8``)
put in the program's place: its own greedy tokens, logits and keys and
values are compared the same way.  Training's control is the program's
own int8 gradient path (``bench/calibrate.py``).
"""
from __future__ import annotations

import statistics

import torch

from .reference import adamw as ref_adamw
from .weights import Weights

__all__ = ["serving_numbers", "train_reference", "train_numbers",
           "verdict"]


def _weights(ctx) -> Weights:
    return Weights(ctx.conf["run"]["init"], ctx.ref_shapes, ctx.seed,
                   ctx.device, ctx.spec.layers)


class _Tally:
    """What one candidate's outputs are compared by: the reference-logit
    gap of every served token, each row's logit distance, and each
    token's distance in every layer's keys and values (all relative to
    the reference's norms), kept call by call."""

    def __init__(self):
        self.gaps, self.rows, self.toks = [], [], {}
        self.num, self.den = {}, {}

    def _sq(self, key, got, want):
        d = (got.float() - want).double()
        self.num[key] = self.num.get(key, 0.0) + float((d * d).sum())
        self.den[key] = self.den.get(key, 0.0) + float(
            (want.double() ** 2).sum())

    def served(self, lr, pick):
        """Reference logits lr (..., V) and the served tokens (...)."""
        got = lr.gather(-1, pick[..., None].long())[..., 0]
        self.gaps.append((lr.max(-1).values - got).reshape(-1).float())

    def logits(self, got, want):
        """A candidate's logits (rows, V) against the reference's."""
        self._sq("logits", got, want)
        self.rows.append(((got.float() - want).norm(dim=-1)
                          / want.norm(dim=-1)).float())

    def cache(self, key, got, want):
        """Keys or values (B, S, heads, hd) against the reference's."""
        self._sq(key, got, want)
        e = ((got.float() - want).flatten(2).norm(dim=-1)
             / want.flatten(2).norm(dim=-1).clamp_min(1e-30))
        self.toks.setdefault(key, []).append(e.reshape(-1).float())

    def numbers(self) -> dict:
        gaps = torch.cat(self.gaps)
        toks = [e for v in self.toks.values() for e in v]
        rel = lambda k: (self.num[k] / self.den[k]) ** 0.5  # noqa: E731
        return {
            "token_gap": float(gaps.max()),
            "gap_mean": float(gaps.mean()),
            "logit_rel": rel("logits"),
            "logit_med": float(torch.cat(self.rows).median()),
            "logit_least": max(float(r.min()) for r in self.rows),
            "cache_rel": max(rel(k) for k in self.toks),
            "cache_med": max(float(e.median()) for e in toks),
            "cache_q75": max(float(torch.quantile(e, 0.75)) for e in toks),
        }


def _cache_leaf(caches, name):
    return next(iter(caches.values()))[name]


def checker(ctx, j: int) -> int:
    """The rank that checks kept batch ``j``: the batches dealt out over
    the ranks in turn."""
    return j % ctx.world


def _merged(parts: list) -> _Tally:
    """One tally of per-batch tallies, in batch order: what one tally fed
    the same batches in that order holds, bit for bit."""
    out = _Tally()
    for t in parts:
        out.gaps += t.gaps
        out.rows += t.rows
        for k, v in t.toks.items():
            out.toks.setdefault(k, []).extend(v)
        for k in t.num:
            out.num[k] = out.num.get(k, 0.0) + t.num[k]
            out.den[k] = out.den.get(k, 0.0) + t.den[k]
    return out


def _moved(t: _Tally, device) -> _Tally:
    out = _Tally()
    out.gaps = [g.to(device) for g in t.gaps]
    out.rows = [r.to(device) for r in t.rows]
    out.toks = {k: [e.to(device) for e in v] for k, v in t.toks.items()}
    out.num, out.den = dict(t.num), dict(t.den)
    return out


def _every_rank(ctx, parts: dict) -> dict:
    """Every rank's per-batch tallies (``parts``: candidate -> this rank's
    batches' tallies, in order), by candidate in batch order, on this
    rank's device."""
    if ctx.world == 1:
        return parts
    import torch.distributed as dist
    every = [None] * ctx.world
    mine = {n: [_moved(t, "cpu") for t in ts] for n, ts in parts.items()}
    dist.all_gather_object(every, mine, group=ctx.host)
    n_batches = sum(len(next(iter(r.values()))) for r in every)
    return {n: [_moved(every[checker(ctx, j)][n][j // ctx.world],
                       ctx.device) for j in range(n_batches)]
            for n in parts}


def _prefill_numbers(ctx, kept, control):
    """The reference layer by layer over this rank's batches (each layer's
    leaves drawn once, applied to every batch, and dropped), each batch
    tallied alone; the tallies of every rank merged in batch order."""
    s, w, ref = ctx.spec, _weights(ctx), ctx.ref
    names = ("program", "control") if control else ("program",)
    mine = [bt for j, bt in enumerate(kept["batches"])
            if checker(ctx, j) == ctx.rank]
    ids = [torch.from_numpy(bt["ids"]).to(ctx.device) for bt in mine]
    kv = [[] for _ in mine]
    hs = ref.forward_batches(s, w, ids, kv=kv, done=w.drop)
    lr = [ref.logits(s, w, h[:, -1]) for h in hs]
    del hs
    cands = [{"program": (bt["logits"], bt["pick"],
                          [(_cache_leaf(bt["caches"], "k")[i],
                            _cache_leaf(bt["caches"], "v")[i])
                           for i in range(s.layers)])} for bt in mine]
    if control:
        kvc = [[] for _ in mine]
        hc = ref.forward_batches(s, w, ids, quant=ref.fp8, kv=kvc,
                                 done=w.drop)
        for c, h, kvs in zip(cands, hc, kvc):
            lc = ref.logits(s, w, h[:, -1], ref.fp8)
            c["control"] = (lc, lc.argmax(-1), kvs)
        del hc
    parts = {n: [] for n in names}
    for c, want, kvr in zip(cands, lr, kv):
        for n, (lg, pick, kvs) in c.items():
            t = _Tally()
            t.served(want, pick)
            t.logits(lg, want)
            for i, ((k, v), (kr, vr)) in enumerate(zip(kvs, kvr)):
                t.cache(("k", i), k, kr)
                t.cache(("v", i), v, vr)
            parts[n].append(t)
    del kv, lr, cands
    every = _every_rank(ctx, parts)
    return {n: _merged(ts).numbers() for n, ts in every.items()}, {}


def _decode_groups(s, b: int, prompt: int, steps: int, device):
    """Each position's MoE token group and its rank in the group, as the
    serving schedule formed them: the prompts' one prefill of b x prompt
    tokens in ``s.groups`` contiguous groups, then each decode step's b
    tokens in its own groups."""
    flat = torch.arange(b * prompt, device=device).reshape(b, prompt)
    g = s.groups if (b * prompt) % s.groups == 0 else 1
    pg, po = flat // (b * prompt // g), flat
    gd = s.groups if b % s.groups == 0 else 1
    rows = torch.arange(b, device=device)[:, None]
    j = torch.arange(steps, device=device)[None, :]
    dg = g + j * gd + rows // (b // gd)
    do = rows.expand(b, steps)
    return torch.cat([pg, dg], 1), torch.cat([po, do], 1)


def _decode_numbers(ctx, kept, control, chunk: int = 16):
    s, w, ref = ctx.spec, _weights(ctx), ctx.ref
    n = kept["steps"]
    b, prompt = kept["ids"].shape
    ids = torch.from_numpy(kept["ids"]).to(ctx.device)
    fed = torch.cat(kept["fed"], 1)                        # (b, n)
    served = torch.cat(kept["served"], 1)                  # (b, n)
    full = torch.cat([ids, fed], 1)
    groups, order = _decode_groups(s, b, prompt, n, ctx.device)
    kv, routes = [], []
    h = ref.forward(s, w, full, groups=groups, order=order, kv=kv,
                    routes=routes)
    read = 0
    for r in routes:                                       # per MoE layer
        r = r.reshape(b, prompt + n, -1)[:, prompt:]
        read += sum(int(torch.unique(r[:, j]).numel()) for j in range(n))
    names = ("program", "control") if control else ("program",)
    tally = {m: _Tally() for m in names}
    hc, kvc = None, []
    if control:
        hc = ref.forward(s, w, full, groups=groups, order=order,
                         quant=ref.fp8, kv=kvc)
    for a in range(0, n, chunk):
        z = min(n, a + chunk)
        lr = ref.logits(s, w, h[:, prompt + a:prompt + z])  # (b, z-a, V)
        tally["program"].served(lr, served[:, a:z])
        lc = None
        if control:
            lc = ref.logits(s, w, hc[:, prompt + a:prompt + z], ref.fp8)
            tally["control"].served(lr, lc.argmax(-1))
        for j, lg in kept["logits"].items():
            if a <= j < z:
                tally["program"].logits(lg, lr[:, j - a])
                if control:
                    tally["control"].logits(lc[:, j - a], lr[:, j - a])
        del lr, lc
    written = prompt + n
    for i in range(s.layers):
        kr, vr = kv[i]
        for name, want in (("k", kr), ("v", vr)):
            got = _cache_leaf(kept["caches"], name)[i][:, :written]
            tally["program"].cache((name, i), got, want)
        if control:
            tally["control"].cache(("k", i), kvc[i][0], kr)
            tally["control"].cache(("v", i), kvc[i][1], vr)
    return ({m: t.numbers() for m, t in tally.items()},
            {"experts_read_per_step": read / max(n, 1)})


def serving_numbers(ctx, kept, control: bool = False):
    """({"program": numbers, "control": numbers}, extra) of a serving
    run's ``kept`` outputs; ``extra`` holds what the reference learned
    that the per-layer counts read (decode: the experts read a step)."""
    ctx.ref.exact_matmuls()
    with torch.no_grad():
        if kept["kind"] == "prefill":
            return _prefill_numbers(ctx, kept, control)
        return _decode_numbers(ctx, kept, control)


def train_reference(ctx, steps: int) -> dict:
    """The reference's first ``steps`` steps on the traffic's batches:
    each step's loss, each leaf's first (clipped) gradient norm, and each
    leaf's change over the steps, by (name, layer)."""
    from . import generate
    s, w, ref = ctx.spec, _weights(ctx), ctx.ref
    ref.exact_matmuls()
    o = ctx.conf["run"]["optimizer"]
    held = w.leaves()
    keys = list(held)
    params = [held[k] for k in keys]
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    sep = ctx.conf[ctx.traffic["separator"]]
    losses, grads = [], None
    for t in range(steps):
        b = generate.train_batch(ctx.traffic, ctx.seed, t, s.vocab, sep)
        tokens = torch.from_numpy(b["tokens"]).to(ctx.device)
        labels = torch.from_numpy(b["labels"]).to(ctx.device)
        loss = ref.train_loss(s, w, tokens, labels)
        g = torch.autograd.grad(loss, params, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for p, x in zip(params, g)]
        losses.append(float(loss.detach()))
        used = ref_adamw.adamw_step(o, t + 1, params, g, m, v)
        if t == 0:
            grads = {k: float(u.norm()) for k, u in zip(keys, used)}
        del g, used, loss
    change = {k: float((p.detach() - p0).norm())
              for k, p, p0 in zip(keys, params, start)}
    return {"losses": losses, "grads": grads, "change": change}


def _worst_gap(got: dict, want: dict, keys) -> float:
    """The worst leaf's |got - want| over the larger of its ``want`` and
    the median leaf's (over ``keys``)."""
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


def train_numbers(kept: dict, want: dict) -> dict:
    """The three training numbers of the program's set-up steps."""
    if set(kept["grads"]) != set(want["grads"]):
        raise RuntimeError("the port's leaves are not the reference's: "
                           f"{sorted(set(kept['grads']) ^ set(want['grads']))}")
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(kept["losses"], want["losses"]))
    med = statistics.median(want["grads"].values())
    moving = [k for k, g in want["grads"].items() if g >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_gap(kept["grads"], want["grads"],
                                   want["grads"]),
            "change_gap": _worst_gap(kept["change"], want["change"], moving)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number that is not finite fails."""
    out = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()
           if k != "test_sizes"}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
