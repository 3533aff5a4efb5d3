"""Model configuration shared by every assigned architecture.

A config fully determines the parameter pytree, the super-block layer
pattern, and the train/prefill/decode computations.  The ten assigned
architectures instantiate these in ``repro_torch.configs``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ARCH_FAMILIES", "LayerKind"]

ARCH_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

# a layer kind is "<mixer>+<ffn>": mixer in {attn, swa, mamba, rwkv},
# ffn in {mlp, moe}
LayerKind = str


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # one of ARCH_FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- layer pattern: `pattern` repeats `n_layers // len(pattern)` times ---
    pattern: Tuple[LayerKind, ...] = ("attn+mlp",)

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    moe_groups: int = 1            # GShard-style token groups: dispatch
                                   # transients scale 1/groups (checkpointed)
    router: str = "softmax"        # "softmax" | "tcam_dt" (beyond-paper)

    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # >0 => SWA for 'swa' mixer layers
    qk_norm: bool = False          # qwen3-style per-head RMSNorm on q/k

    # --- MLP ---
    mlp_act: str = "silu"          # "silu" (swiglu) | "gelu" (geglu)

    # --- SSM (mamba) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 -> ceil(d_model / 16)

    # --- rwkv6 ---
    rwkv_head_dim: int = 64

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0        # >0 => enc-dec; n_layers = decoder layers
    encoder_seq: int = 1500        # stub frontend frames after conv (audio)

    # --- multimodal stub frontend (paligemma) ---
    frontend_tokens: int = 0       # patch embeddings prepended to text

    # --- misc ---
    norm_eps: float = 1e-6
    norm_type: str = "rms"         # "rms" | "nonparam" (olmo)
    tie_embeddings: bool = True
    emb_scale: bool = False        # gemma multiplies embeddings by sqrt(d)

    def __post_init__(self):
        assert self.family in ARCH_FAMILIES, self.family
        assert self.n_layers % len(self.pattern) == 0, (
            self.name, self.n_layers, self.pattern)

    # ---- derived ----
    @property
    def n_repeat(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def kinds(self) -> Tuple[LayerKind, ...]:
        """Distinct layer kinds, stable order of first occurrence."""
        seen: list = []
        for k in self.pattern:
            if k not in seen:
                seen.append(k)
        return tuple(seen)

    def kind_positions(self, kind: LayerKind) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.pattern) if k == kind)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for reporting
        and the 6·N·D model-FLOPs roofline term."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embed (tied head)
        if not self.tie_embeddings:
            total += v * d
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        attn = qkv + self.n_heads * self.head_dim * d
        mlp = 3 * d * self.d_ff if self.mlp_act in ("silu", "gelu") else 2 * d * self.d_ff
        moe = self.n_experts * 3 * d * self.expert_ff + d * self.n_experts
        dtr = self.dt_rank
        mamba = (
            2 * d * self.d_inner                 # in_proj (x, z)
            + self.ssm_conv * self.d_inner       # conv
            + self.d_inner * (dtr + 2 * self.ssm_state)  # x -> dt, B, C
            + dtr * self.d_inner                 # dt_proj
            + self.d_inner * self.ssm_state      # A
            + self.d_inner                       # D
            + self.d_inner * d                   # out_proj
        )
        rwkv = (
            5 * d * d                            # r, k, v, gate, output
            + 2 * d * 64                         # decay LoRA
            + 2 * d                              # decay base, bonus u
        )
        cmix = 2 * d * self.d_ff + d * d         # channel-mix k, v, r
        per_kind = {"attn": attn, "swa": attn, "mamba": mamba, "rwkv": rwkv}
        per_ffn = {"mlp": mlp, "moe": moe, "cmix": cmix}
        for kind in self.pattern:
            mixer, ffn = kind.split("+")
            total += self.n_repeat * per_kind[mixer]
            total += self.n_repeat * per_ffn[ffn]
        if self.is_encdec:
            # encoder self-attn + mlp + decoder cross-attn
            total += self.encoder_layers * (attn + 2 * d * self.d_ff)
            total += self.n_layers * attn        # cross-attention
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts) — the 6·N_active·D
        roofline term."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        moe_all = self.n_experts * 3 * d * self.expert_ff
        moe_act = self.experts_per_token * 3 * d * self.expert_ff
        n_moe_layers = sum(1 for k in self.pattern if k.endswith("+moe"))
        n_moe_layers *= self.n_repeat
        return int(self.n_params() - n_moe_layers * (moe_all - moe_act))
