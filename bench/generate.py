"""The one traffic generator: it reads a traffic file's parameters
(``bench/traffic/<name>.json``) and the seed, and gives the same work for
the same seed on any machine (numpy's generator on the host; ids are a
few hundred kilobytes a batch).

- ``prefill``: batches of ``cycle`` shapes, every shape of the cycle once
  in each run of ``len(cycle)`` batches in an order drawn from the seed,
  so every seed does the same work in another order; token ids uniform
  over the vocabulary.
- ``decode``: ``sessions`` prompts of ``prompt`` uniform ids.
- ``train``: rows of ``seq + 1`` ids packed from documents whose lengths
  are log-normal (``median``, ``sigma``, clipped to [``min``, ``max``]),
  each followed by the separator id; a row's tokens are its first ``seq``
  ids and its labels the last ``seq``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["batch_shapes", "uniform_ids", "train_batch"]


def _rng(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *index])


def batch_shapes(traffic: dict, seed: int):
    """(rows, length) of every batch, without end."""
    cycle = [tuple(c) for c in traffic["cycle"]]
    rng = _rng(seed, 0)
    while True:
        for i in rng.permutation(len(cycle)):
            yield cycle[i]


WINDOW, WARMUP, PROMPTS = 1, 5, 6      # id streams of one seed


def uniform_ids(seed: int, stream: int, index: int, rows: int, length: int,
                vocab: int) -> np.ndarray:
    """Batch ``index`` of id ``stream``: token ids, int64 (rows, length)."""
    return _rng(seed, stream, index).integers(0, vocab, (rows, length))


def train_batch(traffic: dict, seed: int, index: int, vocab: int,
                separator: int) -> dict:
    """Step ``index``'s ``tokens`` and ``labels``, int64 (batch, seq)."""
    b, s = traffic["batch"], traffic["seq"]
    doc = traffic["doc_length"]
    rng = _rng(seed, 2, index)
    rows = np.empty((b, s + 1), dtype=np.int64)
    for r in range(b):
        ids = []
        while len(ids) < s + 1:
            n = int(np.clip(rng.lognormal(np.log(doc["median"]),
                                          doc["sigma"]),
                            doc["min"], doc["max"]))
            ids.extend(rng.integers(0, vocab, n).tolist())
            ids.append(separator)
        rows[r] = ids[:s + 1]
    return {"tokens": rows[:, :-1].copy(), "labels": rows[:, 1:].copy()}
