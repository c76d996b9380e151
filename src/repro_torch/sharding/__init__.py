"""Sharding (port of ``repro/sharding``): the logical-axis rules and the
1-D serving mesh the cluster-sharded executor runs over."""
from .logical import Mesh, default_rules, serving_mesh, shardable, spec_for

__all__ = ["Mesh", "default_rules", "serving_mesh", "spec_for", "shardable"]
