"""The frozen work counts against the card logs' figures of the program's
own arithmetic (``chip_smoke.py``'s ``lm_work`` and ``train_work``,
``"function"``), and the peak tables."""
from __future__ import annotations

import ast
import pathlib

import pytest

from bench.work import Sizes, least_seconds, lm_work, peaks, train_work

OLMO = Sizes(d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128, d_ff=8192,
             vocab_size=50304, n_layers=16)
QWEN3_L4 = Sizes(d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
                 d_ff=1536, vocab_size=151936, n_layers=4,
                 pattern=("attn+moe",), n_experts=128, experts_per_token=8,
                 moe_d_ff=1536)


def _params(s: Sizes, tied: bool = True) -> int:
    """Every leaf of the port's tree (norm scales included)."""
    d, hd = s.d_model, s.head_dim
    per = (d * (s.n_heads + 2 * s.n_kv_heads) * hd + s.n_heads * hd * d
           + 2 * d)
    if s.n_experts:
        f = s.moe_d_ff
        per += d * s.n_experts + 3 * s.n_experts * d * f + 2 * hd
    else:
        per += 3 * d * s.d_ff
    head = 0 if tied else d * s.vocab_size
    return s.vocab_size * d + head + d + s.n_layers * per


def test_olmo_train_step_pinned():
    """phase 11's olmo-1b step at 8 x 2048 (PRs 20-25's card logs)."""
    n = _params(OLMO)
    assert n == 1_176_832_000
    w = train_work(OLMO, 8, 2048, n)
    assert w["bf16_ops"] == 122_280_940_142_592
    assert w["f32_ops"] == 0
    assert w["bytes"] == 32_951_296_000


def test_qwen3_phase9_pinned():
    """phase 9's qwen3-moe (4 of 94 layers): prefill 8 x 2048 and a decode
    step at batch 8 over 2080 slots with 197 experts read (its card
    log)."""
    weights = (_params(QWEN3_L4, tied=False)
               - QWEN3_L4.vocab_size * 4096) * 4
    pre = lm_work(QWEN3_L4, weights, 8, 2048)
    assert pre["bf16_ops"] == 31_347_112_411_136
    assert pre["f32_ops"] == 68_719_476_736
    assert pre["bytes"] == 42_698_500_096
    dec = lm_work(QWEN3_L4, weights, 8, 1, 2080, experts_read=197)
    assert dec["bf16_ops"] == 26_365_394_944
    assert dec["f32_ops"] == 33_554_432
    assert dec["bytes"] == 18_650_589_184


def test_peaks_and_bound():
    assert peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert peaks("NVIDIA H100 NVL") == (835e12, 3.9e12)
    with pytest.raises(RuntimeError):
        peaks("some other card")
    t, by = least_seconds({"bf16_ops": 989e12, "f32_ops": 0,
                           "bytes": 1.0}, 989e12, 3.35e12)
    assert (t, by) == (1.0, "operations")
    t, by = least_seconds({"bf16_ops": 0, "f32_ops": 0, "bytes": 6.7e12},
                          989e12, 3.35e12)
    assert (t, by) == (2.0, "bytes")


def test_work_imports_nothing_of_the_program():
    tree = ast.parse(pathlib.Path(__file__).with_name("work.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert all(n.split(".")[0] in ("__future__", "dataclasses")
               for n in names), names
