"""Logical-axis sharding rules (MaxText-style) for the LM substrate, over a
``DeviceMesh`` or a device-free mesh shape, and the explicit collectives
of sharded serving (``Shards``)."""
from .collectives import Shards
from .rules import (
    Rules,
    current_rules,
    make_rules,
    mesh_sizes,
    mesh_spec,
    shard,
    use_rules,
)

__all__ = ["Rules", "Shards", "current_rules", "make_rules", "mesh_sizes",
           "mesh_spec", "shard", "use_rules"]
