"""Launch layer: production mesh shapes, meshes over a process group, and
the per-cell dry run (``python -m repro_torch.launch.dryrun``)."""
from .mesh import MeshShape, make_production_mesh, mesh_for_devices

__all__ = ["MeshShape", "make_production_mesh", "mesh_for_devices"]
