"""What a step of the port needs, counted from shapes: the operations and
bytes of a prefill, a decode step and a train step, and the published peaks
of the card.  A frozen copy of the ``"function"`` counts of
``chip_smoke.py``'s ``lm_work`` and ``train_work`` and of its
``PEAK_FLOPS`` / ``PEAK_BW`` tables; it imports nothing of the port, so no
change to the program moves it.

The work counted is what the inputs need, whatever implements them: each
token's ``k`` routed experts (not capacity slots), the causal pairs of
attention in bf16, each weight read once in the dtype the configuration
states, the cache or state written (prefill) or read (decode) once.  A
multiply-add counts two operations.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Sizes", "lm_work", "train_work", "least_seconds", "peaks",
           "PEAK_FLOPS", "PEAK_BW"]

# Dense peak rates by card (NVIDIA data sheets, no sparsity), operations/s:
# bf16 on the tensor cores, f32 outside them.  The name decides.
PEAK_FLOPS = (("H200", 989e12, 67e12), ("H100 NVL", 835e12, 60e12),
              ("H100 PCIe", 756e12, 51e12), ("H100", 989e12, 67e12))
# Peak memory rate by card (NVIDIA data sheets), bytes/s.
PEAK_BW = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
           ("H100", 3.35e12))


def peaks(name: str) -> tuple[float, float]:
    """(bf16 operations/s, bytes/s) of the card called ``name``."""
    flops = next((bf16 for key, bf16, _ in PEAK_FLOPS if key in name), None)
    bw = next((b for key, b in PEAK_BW if key in name), None)
    if flops is None or bw is None:
        raise RuntimeError(f"no peak entry for card {name!r}")
    return flops, bw


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The sizes the counts read, taken from a model configuration's
    stated fields (the derived ones are worked out here)."""
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    n_layers: int
    pattern: tuple = ("attn+mlp",)
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0

    @classmethod
    def of(cls, cfg) -> "Sizes":
        """The fields of ``cfg`` (any object with these attributes)."""
        return cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cls)})


def lm_work(s: Sizes, weight_bytes: int, batch: int, seq: int,
            cache_len: int = 0, experts_read: int | None = None) -> dict:
    """``{"bf16_ops", "f32_ops", "bytes"}`` of one prefill of ``batch`` x
    ``seq`` tokens (``cache_len`` 0) or one decode step of ``batch`` tokens
    over a ``cache_len`` cache.

    Bytes: ``weight_bytes`` (every weight the step reads, once), the
    embedding rows gathered (4*t*d), the last logits written (2*batch*V),
    and per attention layer its cache written (prefill) or read (decode).
    Of the experts' weights only the ``experts_read`` (summed over MoE
    layers; all if None) that the tokens chose count.

    Only the layer kinds of the benchmark's cells are counted (attention,
    the SwiGLU MLP, routed experts); a cell of another kind brings its
    counts with it."""
    d, v = s.d_model, s.vocab_size
    nh, kv, hd = s.n_heads, s.n_kv_heads, s.head_dim
    f = s.d_ff
    fe = s.moe_d_ff or f
    t = batch * seq
    keys = cache_len or seq
    causal_pairs = (batch * cache_len if cache_len
                    else batch * seq * (seq + 1) // 2)
    qk_pv = 2 * 2 * nh * hd
    proj = 2 * t * d * (nh + 2 * kv) * hd + 2 * t * nh * hd * d
    w = {"bf16_ops": 0, "f32_ops": 0, "bytes": 0}
    n_moe = 0
    for layer in s.pattern * (s.n_layers // len(s.pattern)):
        mixer, ffn = layer.split("+")
        if mixer not in ("attn", "swa") or ffn not in ("mlp", "moe"):
            raise ValueError(f"no count for a layer of kind {layer!r}")
        w["bf16_ops"] += proj + qk_pv * causal_pairs
        w["bytes"] += 2 * batch * keys * kv * hd * 2
        if ffn == "mlp":
            w["bf16_ops"] += 6 * t * d * f
        else:
            w["bf16_ops"] += 3 * 2 * t * s.experts_per_token * d * fe
            w["f32_ops"] += 2 * t * d * s.n_experts
            n_moe += 1
    w["bf16_ops"] += 2 * batch * d * v
    w["bytes"] += weight_bytes + 4 * min(t, v) * d + 2 * batch * v
    if n_moe and experts_read is not None:
        unread = n_moe * s.n_experts - experts_read
        w["bytes"] -= unread * 3 * d * fe * 4
    return w


def train_work(s: Sizes, batch: int, seq: int, n_params: int,
               elem: int = 4) -> dict:
    """One train step of ``batch`` x ``seq`` tokens: three times a
    prefill's operations (forward, and a backward of twice it) with the
    head widened to every token, and the state the update reads and
    writes, 7 elements of ``elem`` bytes a parameter (param, first and
    second moment read and written, gradient read)."""
    fwd = lm_work(s, 0, batch, seq)
    head = 2 * (batch * seq - batch) * s.d_model * s.vocab_size
    return {"bf16_ops": 3 * (fwd["bf16_ops"] + head),
            "f32_ops": 3 * fwd["f32_ops"],
            "bytes": 7 * elem * n_params}


def least_seconds(work: dict, flops: float, bw: float) -> tuple[float, str]:
    """The least time for ``work`` on a card of peak ``flops`` and ``bw``:
    the larger of every operation over the bf16 peak and the bytes over
    the memory rate, and which of the two bounds it."""
    t_ops = (work["bf16_ops"] + work["f32_ops"]) / flops
    t_bytes = work["bytes"] / bw
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
