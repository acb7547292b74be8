"""Logical-axis sharding over a ``torch.distributed`` device mesh
(counterpart of ``repro.parallel``)."""
from .sharding import (
    ShardingRules,
    act_spec,
    current_mesh,
    current_rules,
    default_rules,
    param_specs,
    shard,
    use_mesh,
)

__all__ = [
    "ShardingRules",
    "default_rules",
    "use_mesh",
    "current_mesh",
    "current_rules",
    "shard",
    "act_spec",
    "param_specs",
]
