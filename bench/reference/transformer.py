"""Plain float32 reference of the decoder-only attention models the
benchmark runs (Qwen3-MoE, OLMo): embedding, per layer a pre-norm
attention block (RoPE, optional per-head RMSNorm on q and k, grouped-query
heads, causal softmax) and a pre-norm FFN (SwiGLU MLP, or a softmax router
over the experts with top-k gates renormalised and GShard capacity
dispatch), the final norm and the head.

Written from the published architectures, in plain ``torch`` operations,
float32 throughout with TF32 off (``exact_matmuls``).  It imports nothing
of the port and takes no tensor the port made: weights come from
``bench.weights`` by name, inputs from the traffic generator.  Every
product goes through ``quant``, so the same code computes the lower
precision control (``fp8``).

The capacity rule is the configuration's stated one: each token group
holds ``ceil(cf * n * k / E)`` dispatches an expert (rounded up to a
multiple of 8, at least 8); dispatches are ranked within their (group,
expert) in the order the serving schedule gave the tokens, and those past
capacity are dropped.  A caller states each token's group and order, so
one forward covers a prefill's groups and a decode step's alike.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

__all__ = ["Spec", "leaf_shapes", "exact_matmuls", "fp8", "exact",
           "forward", "forward_batches", "logits", "capacity", "train_loss"]


def exact_matmuls() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor
    (its largest magnitude to 448), back in float32: the control's
    operands."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s


@dataclasses.dataclass(frozen=True)
class Spec:
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    layers: int
    ffn: str                 # "moe" | "mlp"
    ffn_dim: int             # expert width (moe) or MLP hidden width
    experts: int
    top_k: int
    norm: str                # "rms" (scale as 1 + w) | "nonparam"
    eps: float
    theta: float
    qk_norm: bool
    tied: bool
    capacity_factor: float = 1.25
    groups: int = 1


def leaf_shapes(s: Spec) -> dict:
    """Every weight by name: (shape, per layer or not)."""
    d, hd, f = s.d, s.head_dim, s.ffn_dim
    out = {"embed": ((s.vocab, d), False), "final_norm": ((d,), False)}
    if not s.tied:
        out["lm_head"] = ((d, s.vocab), False)
    out.update(norm1=((d,), True), wq=((d, s.heads * hd), True),
               wk=((d, s.kv_heads * hd), True),
               wv=((d, s.kv_heads * hd), True),
               wo=((s.heads * hd, d), True), norm2=((d,), True))
    if s.qk_norm:
        out.update(q_norm=((hd,), True), k_norm=((hd,), True))
    if s.ffn == "moe":
        e = s.experts
        out.update(w_router=((d, e), True), w_gate=((e, d, f), True),
                   w_up=((e, d, f), True), w_down=((e, f, d), True))
    else:
        out.update(w_gate=((d, f), True), w_up=((d, f), True),
                   w_down=((f, d), True))
    return out


def capacity(s: Spec, n: int) -> int:
    c = math.ceil(s.capacity_factor * n * s.top_k / s.experts)
    return max(8, -(-c // 8) * 8)


def _norm(s: Spec, x, scale):
    if s.norm == "nonparam":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + s.eps)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + s.eps) * (
        1.0 + scale)


def _rope(s: Spec, x, pos):
    """Rotary embedding over the two halves of each head (x: (..., S, n,
    hd), pos: (S,))."""
    half = s.head_dim // 2
    freq = s.theta ** (-torch.arange(half, dtype=torch.float64,
                                     device=x.device) / half)
    ang = (pos.double()[:, None] * freq).float()
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(s: Spec, q, k, v, quant, block: int = 1024):
    """Causal softmax attention of one row: q (S, H, hd), k and v (S, KV,
    hd), in query blocks."""
    n = q.shape[0]
    g = s.heads // s.kv_heads
    kk = quant(k).repeat_interleave(g, dim=1).transpose(0, 1)   # (H, S, hd)
    vv = quant(v).repeat_interleave(g, dim=1).transpose(0, 1)
    qq = quant(q).transpose(0, 1)
    out = []
    for a in range(0, n, block):
        b = min(n, a + block)
        sc = (qq[:, a:b] @ kk[:, :b].transpose(1, 2)) * s.head_dim ** -0.5
        mask = (torch.arange(b, device=q.device)[None, :]
                <= torch.arange(a, b, device=q.device)[:, None])
        sc = sc.masked_fill(~mask, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out.append(quant(p) @ vv[:, :b])
    return torch.cat(out, dim=1).transpose(0, 1)                 # (S, H, hd)


def _moe(s: Spec, w, layer, x, groups, order, quant, routes=None):
    """The MoE FFN of tokens x (T, d); ``groups`` (T,) each token's token
    group, ``order`` (T,) its rank in the group's serving order, each
    group of ``n`` tokens holding ``capacity(n)`` dispatches an expert."""
    t = x.shape[0]
    e, k = s.experts, s.top_k
    gates = torch.softmax(quant(x) @ quant(w("w_router", layer)), dim=-1)
    top_w, top_i = torch.topk(gates, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    if routes is not None:
        routes.append(top_i)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    ex = top_i.reshape(-1)
    key = groups[tok] * e + ex
    sort = torch.argsort(key * (int(order.max()) + 1) + order[tok])
    n_keys = int(groups.max()) * e + e
    counts = torch.bincount(key, minlength=n_keys)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(ex)
    rank[sort] = torch.arange(t * k, device=x.device) - starts[key[sort]]
    sizes = torch.bincount(groups)
    caps = torch.tensor([capacity(s, int(c)) for c in sizes.tolist()],
                        device=x.device)
    keep = rank < caps[groups[tok]]
    gw = top_w.reshape(-1)
    wg, wu, wd = w("w_gate", layer), w("w_up", layer), w("w_down", layer)
    y = torch.zeros_like(x)
    for j in range(e):
        sel = torch.nonzero((ex == j) & keep).squeeze(1)
        if sel.numel() == 0:
            continue
        rows = tok[sel]
        xe = quant(x[rows])
        hid = F.silu(xe @ quant(wg[j])) * (xe @ quant(wu[j]))
        y.index_add_(0, rows, (quant(hid) @ quant(wd[j])) * gw[sel, None])
    return y


def _mlp(w, layer, x, quant):
    xq = quant(x)
    hid = F.silu(xq @ quant(w("w_gate", layer))) * (xq @ quant(w("w_up",
                                                                  layer)))
    return quant(hid) @ quant(w("w_down", layer))


def _layer(s: Spec, w, layer, h, pos, groups, order, quant, kv=None,
           routes=None):
    """One decoder layer over h (B, S, d); appends (k, v) to ``kv``."""
    b, n, d = h.shape
    hd = s.head_dim
    x = _norm(s, h, w("norm1", layer))
    xq = quant(x)
    q = (xq @ quant(w("wq", layer))).reshape(b, n, s.heads, hd)
    k = (xq @ quant(w("wk", layer))).reshape(b, n, s.kv_heads, hd)
    v = (xq @ quant(w("wv", layer))).reshape(b, n, s.kv_heads, hd)
    if s.qk_norm:
        q = _norm(s, q, w("q_norm", layer))
        k = _norm(s, k, w("k_norm", layer))
    q, k = _rope(s, q, pos), _rope(s, k, pos)
    if kv is not None:
        kv.append((k, v))
    o = torch.stack([_attend(s, q[i], k[i], v[i], quant) for i in range(b)])
    h = h + quant(o.reshape(b, n, s.heads * hd)) @ quant(w("wo", layer))
    x = _norm(s, h, w("norm2", layer))
    if s.ffn == "moe":
        y = _moe(s, w, layer, x.reshape(b * n, d), groups.reshape(-1),
                 order.reshape(-1), quant, routes).reshape(b, n, d)
    else:
        y = _mlp(w, layer, x, quant)
    return h + y


def forward(s: Spec, w, tokens, *, groups=None, order=None, quant=exact,
            kv=None, routes=None):
    """The final-normed hidden states (B, S, d) of ``tokens`` (B, S).
    ``groups``/``order`` (B, S): each token's MoE token group and its rank
    in that group's order (default: the batch's ``s.groups`` contiguous
    groups of the flattened tokens).  ``kv`` (a list) collects each
    layer's keys (after RoPE) and values; ``routes`` each MoE layer's
    expert choices."""
    if groups is None:
        groups, order = _batch_groups(s, tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    h = w("embed")[tokens].float()
    for layer in range(s.layers):
        h = _layer(s, w, layer, h, pos, groups, order, quant, kv, routes)
    return _norm(s, h, w("final_norm"))


def _batch_groups(s: Spec, tokens):
    """A batch's ``s.groups`` contiguous token groups of its flattened
    tokens (one where they do not divide it), and each token's order."""
    b, n = tokens.shape
    flat = torch.arange(b * n, device=tokens.device).reshape(b, n)
    g = s.groups if (b * n) % max(s.groups, 1) == 0 else 1
    return flat // (b * n // g), flat


def forward_batches(s: Spec, w, batches, *, quant=exact, kv=None,
                    done=None):
    """``forward`` of each of ``batches`` ((B, S) tokens each, default
    groups), layer-major: every batch through layer i before any enters
    layer i + 1, then ``done(i)`` (where the caller lets go of layer i's
    leaves).  Each batch's arithmetic is ``forward``'s, bit for bit.
    ``kv``: a list per batch, filled as ``forward``'s."""
    state = []
    for tokens in batches:
        groups, order = _batch_groups(s, tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        state.append([w("embed")[tokens].float(), pos, groups, order])
    for layer in range(s.layers):
        for j, st in enumerate(state):
            st[0] = _layer(s, w, layer, st[0], *st[1:], quant,
                           None if kv is None else kv[j])
        if done is not None:
            done(layer)
    return [_norm(s, st[0], w("final_norm")) for st in state]


def logits(s: Spec, w, h, quant=exact):
    """The head's logits of hidden states h (..., d)."""
    head = w("embed").T if s.tied else w("lm_head")
    return quant(h) @ quant(head)


def train_loss(s: Spec, w, tokens, labels, chunk: int = 2048):
    """Mean next-token cross-entropy over every label (MLP models), each
    layer and each loss chunk recomputed in the backward (memory, not
    arithmetic: the values are the plain forward's)."""
    b, n = tokens.shape
    pos = torch.arange(n, device=tokens.device)
    dummy = torch.zeros((b, n), dtype=torch.long, device=tokens.device)
    h = w("embed")[tokens].float()
    for layer in range(s.layers):
        h = _ckpt.checkpoint(_layer, s, w, layer, h, pos, dummy, dummy,
                             exact, use_reentrant=False)
    h = _norm(s, h, w("final_norm")).reshape(b * n, s.d)
    lab = labels.reshape(-1)

    def part(hc, lc):
        return F.cross_entropy(logits(s, w, hc), lc, reduction="sum")
    tot = sum(_ckpt.checkpoint(part, h[a:a + chunk], lab[a:a + chunk],
                               use_reentrant=False)
              for a in range(0, b * n, chunk))
    return tot / lab.numel()
