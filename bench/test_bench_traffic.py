"""The traffic generator: the same seed gives the same work, and seeds
differ only in the order and the ids of the same work."""
from __future__ import annotations

import itertools
import json
import pathlib

import numpy as np
import pytest

from bench import generate

TRAFFIC = pathlib.Path(__file__).resolve().parent / "traffic"
SEEDS = (0, 7, 2**31 + 12345, 3_000_000_000)


def _load(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_shapes_repeat_and_keep_the_cycle(seed):
    t = _load("prefill-mix")
    a = list(itertools.islice(generate.batch_shapes(t, seed), 40))
    b = list(itertools.islice(generate.batch_shapes(t, seed), 40))
    assert a == b
    cycle = sorted(tuple(c) for c in t["cycle"])
    for i in range(0, 40, len(cycle)):
        assert sorted(a[i:i + len(cycle)]) == cycle
    assert all(r * s == 16384 for r, s in a)


def test_prefill_orders_differ_between_seeds():
    t = _load("prefill-mix")
    orders = {tuple(itertools.islice(generate.batch_shapes(t, s), 12))
              for s in SEEDS}
    assert len(orders) > 1


@pytest.mark.parametrize("seed", SEEDS)
def test_ids_repeat(seed):
    a = generate.uniform_ids(seed, generate.WINDOW, 3, 4, 64, 151936)
    b = generate.uniform_ids(seed, generate.WINDOW, 3, 4, 64, 151936)
    c = generate.uniform_ids(seed, generate.WARMUP, 3, 4, 64, 151936)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 151936


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat_and_pack_documents(seed):
    t = _load("train-8x2048")
    a = generate.train_batch(t, seed, 5, 50304, 50279)
    b = generate.train_batch(t, seed, 5, 50304, 50279)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["tokens"].shape == (8, 2048) == a["labels"].shape
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    # documents of log-normal length end in the separator
    seps = (a["tokens"] == 50279).sum(axis=1)
    assert seps.sum() >= 1 and seps.mean() < 2048 / 100
    other = generate.train_batch(t, seed, 6, 50304, 50279)
    assert not np.array_equal(a["tokens"], other["tokens"])
