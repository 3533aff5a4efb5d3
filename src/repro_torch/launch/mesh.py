"""Meshes.

``make_production_mesh`` gives the production topology as a device-free
``MeshShape`` (axis names and sizes, no devices), which is all the sharding
rules, ``train.input_specs`` and the dry run read: TPU v5e pods, 256 chips
each, 16x16 (data, model) per pod; multi-pod adds a leading "pod" axis:
(2, 16, 16).

``mesh_for_devices`` builds a real ``DeviceMesh`` of shape (n, 1) over the
default process group (one rank per device), on the card unless
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import math

from ..device import DeviceLike, resolve_device

__all__ = ["MeshShape", "make_production_mesh", "mesh_for_devices"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with ``DeviceMesh``'s attribute names
    (``shape``, ``mesh_dim_names``) and no devices behind it."""
    shape: tuple
    mesh_dim_names: tuple

    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def mesh_for_devices(n: int | None = None, device: DeviceLike = None):
    """A (data, model) = (n, 1) ``DeviceMesh`` over the default process
    group, whose world size must be ``n`` (default: the world size)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("mesh_for_devices needs the default process "
                           "group: call torch.distributed.init_process_group "
                           "first")
    world = dist.get_world_size()
    n = n or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a process group of "
                         f"{world} ranks")
    return init_device_mesh(dev.type, (n, 1), mesh_dim_names=("data", "model"))
