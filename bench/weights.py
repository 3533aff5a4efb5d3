"""Weights from the seed, made on the device in a few large calls: one
``torch.Generator`` per (leaf, layer), seeded from ``--seed`` and the
leaf's name, so any one layer's leaf can be drawn again alone and both
sides (the port's tree, the reference layer by layer) hold the same
numbers.  Each leaf's rule comes from the configuration file's
``run.init`` table: ``["normal", std]``, ``["fan_in", axis]`` (std
``1/sqrt(shape[axis])``) or ``["zeros"]``.
"""
from __future__ import annotations

import hashlib

import torch

__all__ = ["leaf_seed", "fill", "Weights"]


def leaf_seed(seed: int, name: str, layer: int | None) -> int:
    """A 63-bit generator seed for leaf ``name`` of ``layer``."""
    digest = hashlib.sha256(f"{seed}/{name}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def fill(out: torch.Tensor, rule: list, seed: int, name: str,
         layer: int | None) -> torch.Tensor:
    """Fill the f32 tensor ``out`` (one layer's leaf) in place."""
    kind = rule[0]
    if kind == "zeros":
        return out.zero_()
    gen = torch.Generator(device=out.device)
    gen.manual_seed(leaf_seed(seed, name, layer))
    if kind == "normal":
        std = float(rule[1])
    elif kind == "fan_in":
        std = out.shape[int(rule[1])] ** -0.5
    else:
        raise ValueError(f"unknown init rule {rule!r} for {name}")
    return out.normal_(0.0, std, generator=gen)


class Weights:
    """``w(name, layer=None)``: leaf ``name`` (of ``layer``), drawn on
    ``device`` the first time it is asked for, and kept until
    ``drop(layer)``."""

    def __init__(self, init: dict, shapes: dict, seed: int, device,
                 layers: int):
        self.init, self.shapes, self.seed = init, shapes, seed
        self.device, self.layers = device, layers
        self.held: dict = {}

    def __call__(self, name: str, layer: int | None = None) -> torch.Tensor:
        key = (name, layer)
        if key not in self.held:
            shape, _ = self.shapes[name]
            out = torch.empty(shape, dtype=torch.float32, device=self.device)
            self.held[key] = fill(out, self.init[name], self.seed, name,
                                  layer)
        return self.held[key]

    def drop(self, layer: int) -> None:
        """Let go of every leaf of ``layer`` (drawn again if asked for)."""
        for key in [k for k in self.held if k[1] == layer]:
            del self.held[key]

    def leaves(self) -> dict:
        """Every leaf as a tensor that requires a gradient, by (name,
        layer) (training's reference)."""
        for name, (_, per_layer) in self.shapes.items():
            for layer in (range(self.layers) if per_layer else (None,)):
                self(name, layer).requires_grad_(True)
        return self.held
