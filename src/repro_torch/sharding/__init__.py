"""Logical-axis sharding rules (MaxText-style) for the LM substrate, over a
``DeviceMesh`` or a device-free mesh shape."""
from .rules import (
    Rules,
    current_rules,
    make_rules,
    mesh_sizes,
    mesh_spec,
    shard,
    use_rules,
)

__all__ = ["Rules", "current_rules", "make_rules", "mesh_sizes", "mesh_spec",
           "shard", "use_rules"]
