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


def _slice(t: torch.Tensor, spec: tuple, rules) -> torch.Tensor:
    """This rank's part of ``t`` laid out by ``spec``, as
    ``repro_torch.models.params.shard_params`` cuts it (a tuple axis major
    to minor)."""
    for i, axis in enumerate(spec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is None or rules.sizes[a] == 1:
                continue
            n = t.shape[i] // rules.sizes[a]
            t = t.narrow(i, rules.mesh.get_local_rank(a) * n, n)
    return t


def port_params(cfg, conf: dict, ref_shapes: dict, seed: int, device,
                rules=None):
    """The port's f32 parameter tree (its own structure, from
    ``param_shapes``) holding the benchmark's weights: each leaf, and each
    layer's slice of a stacked one, drawn by ``weights.fill`` under the
    leaf's name, as the reference draws it.  Raises where the port's leaf
    has another shape than the reference's.

    With ``rules`` (a ``DeviceMesh``'s), each leaf is this rank's
    ``DTensor`` shard, laid out as ``shard_params`` lays the whole tree
    out: each (leaf, layer) is drawn whole into one buffer, under the same
    name and seed, and only this rank's slice of it is kept, so no rank
    holds more than one whole layer's leaf beyond its shards."""
    from repro_torch.models.params import param_logical_axes, param_shapes
    init = conf["run"]["init"]

    def build(path, meta, axes):
        name = path[-1]
        want, per_layer = ref_shapes[name]
        shape = tuple(meta.shape)
        if tuple(shape[1:] if per_layer else shape) != tuple(want):
            raise ValueError(f"port leaf {path} {shape}: the reference's "
                             f"{'layer ' if per_layer else ''}is {want}")
        layers = range(shape[0]) if per_layer else (None,)
        if rules is None:
            out = torch.empty(shape, dtype=torch.float32, device=device)
            for layer in layers:
                fill(out if layer is None else out[layer], init[name], seed,
                     name, layer)
            return out
        from repro_torch.sharding.collectives import as_dtensor
        spec = rules.spec(axes, shape)
        local = torch.empty(rules.local_shape(shape, spec),
                            dtype=torch.float32, device=device)
        whole = torch.empty(tuple(want), dtype=torch.float32, device=device)
        for layer in layers:
            fill(whole, init[name], seed, name, layer)
            part = _slice(whole, spec[1:] if per_layer else spec, rules)
            (local if layer is None else local[layer]).copy_(part)
        del whole
        return as_dtensor(local, rules, axes, shape)

    def rebuild(tree, axes, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, axes[k], path + (k,))
                    for k, v in tree.items()}
        return build(path, tree, axes)
    return rebuild(param_shapes(cfg), param_logical_axes(cfg))


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
