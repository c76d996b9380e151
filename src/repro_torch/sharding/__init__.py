"""Sharding (port of ``repro/sharding``): the logical-axis rules, the
1-D serving mesh the cluster-sharded executor runs over, and the LM
side's N-D logical mesh and sharding descriptions."""
from .logical import (LogicalMesh, Mesh, NamedSharding, constrain,
                      default_rules, guarded_sharding, maybe_constrain,
                      serving_mesh, set_active_mesh_axes, shardable,
                      sharding_for, spec_for, tree_shardings)

__all__ = ["Mesh", "LogicalMesh", "NamedSharding", "default_rules",
           "serving_mesh", "spec_for", "shardable", "guarded_sharding",
           "sharding_for", "tree_shardings", "constrain",
           "set_active_mesh_axes", "maybe_constrain"]
