"""Deterministic synthetic LM data pipeline.

Design goals (1000+ node posture):
  * **Resumable by construction** — every batch is a pure function of
    ``(seed, step)``; restoring a checkpoint at step k reproduces the exact
    stream with no iterator state to persist.
  * **Shard-aware** — ``batch_at(step, shard, n_shards)`` yields only the
    host's slice of the global batch, identical to what a global batch
    sharded over hosts would contain.
  * **Learnable** — tokens follow a planted successor recurrence
    (t_{i+1} = (t_i + c) mod V with segment resets and noise) that a small
    LM learns within tens of steps, so training losses drop measurably and
    loss curves are comparable across runs/configs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models.config import ModelConfig

__all__ = ["TokenPipeline", "make_batch"]


@dataclasses.dataclass
class TokenPipeline:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    noise: float = 0.02

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        assert self.global_batch % n_shards == 0
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        v = self.cfg.vocab_size
        text = self.seq_len - self.cfg.frontend_tokens
        # per-sequence stride c: the model must learn t -> (t + c) mod V
        # conditioned on the sequence's early tokens
        c = rng.integers(1, min(v, 17), size=(b, 1))
        i_idx = np.arange(text + 1)[None, :]
        start = rng.integers(0, v, size=(b, 1))
        toks = (start + c * i_idx) % v
        # segment resets + token noise keep entropy bounded away from zero
        resets = rng.random((b, text + 1)) < 1.0 / 256
        toks[resets] = rng.integers(0, v, size=int(resets.sum()))
        noise = rng.random((b, text + 1)) < self.noise
        toks[noise] = rng.integers(0, v, size=int(noise.sum()))
        batch = {
            "tokens": toks[:, :text].astype(np.int32),
            "labels": toks[:, 1: text + 1].astype(np.int32),
        }
        if self.cfg.frontend_tokens:
            batch["patches"] = rng.standard_normal(
                (b, self.cfg.frontend_tokens, self.cfg.d_model),
                dtype=np.float32) * 0.02
        if self.cfg.is_encdec:
            batch["frames"] = rng.standard_normal(
                (b, self.cfg.encoder_seq, self.cfg.d_model),
                dtype=np.float32) * 0.02
        return batch


def make_batch(cfg: ModelConfig, batch: int, seq: int, step: int = 0,
               seed: int = 0) -> dict:
    return TokenPipeline(cfg, batch, seq, seed=seed).batch_at(step)
