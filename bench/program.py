"""What the benchmark takes from the program, ``repro_torch``: its model
configuration, its parameter tree filled with the benchmark's own weights,
and its step builders.  Everything the port is asked for goes through
here; the reference never imports this module.
"""
from __future__ import annotations

import dataclasses

import torch

from .weights import fill

__all__ = ["port_config", "port_params", "tree_leaves"]


def port_config(conf: dict):
    """The port's ``ModelConfig`` of a configuration file: the named
    architecture with the file's ``run.replace`` fields."""
    from repro_torch.configs import get_config
    run = conf["run"]
    return dataclasses.replace(get_config(run["arch"]),
                               **run.get("replace", {}))


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def port_params(cfg, conf: dict, ref_shapes: dict, seed: int, device):
    """The port's f32 parameter tree (its own structure, from
    ``param_shapes``) holding the benchmark's weights: each leaf, and each
    layer's slice of a stacked one, drawn by ``weights.fill`` under the
    leaf's name, as the reference draws it.  Raises where the port's leaf
    has another shape than the reference's."""
    from repro_torch.models.params import param_shapes
    init = conf["run"]["init"]

    def build(path, meta):
        name = path[-1]
        want, per_layer = ref_shapes[name]
        out = torch.empty(tuple(meta.shape), dtype=torch.float32,
                          device=device)
        if per_layer:
            if tuple(meta.shape[1:]) != tuple(want):
                raise ValueError(f"port leaf {path} {tuple(meta.shape)}: "
                                 f"the reference's layer is {want}")
            for layer in range(meta.shape[0]):
                fill(out[layer], init[name], seed, name, layer)
        else:
            if tuple(meta.shape) != tuple(want):
                raise ValueError(f"port leaf {path} {tuple(meta.shape)}: "
                                 f"the reference's is {want}")
            fill(out, init[name], seed, name, None)
        return out

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        return build(path, tree)
    return rebuild(param_shapes(cfg))


def tree_leaves(tree) -> list:
    """(leaf name, layer or None, tensor) of every leaf of a port tree and
    every layer of a stacked one, in the tree's order."""
    out = []
    for path, t in _walk(tree):
        if path[0] == "blocks":
            out += [(path[-1], i, t[i]) for i in range(t.shape[0])]
        else:
            out.append((path[-1], None, t))
    return out
