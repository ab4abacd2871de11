from .sharding import (ShardingRules, batch_placements, cache_placements,
                       opt_placements, param_placements, to_placements)

__all__ = ["ShardingRules", "batch_placements", "cache_placements",
           "opt_placements", "param_placements", "to_placements"]
