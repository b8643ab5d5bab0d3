"""``paddle.distributed.sharding`` — the ZeRO group-sharded user API
(ref: ``python/paddle/distributed/sharding/group_sharded.py``); the
mechanics live in ``fleet.meta_parallel.sharding.group_sharded``."""
from .fleet.meta_parallel.sharding.group_sharded import (
    GroupShardedStage2, GroupShardedStage3, group_sharded_parallel,
    save_group_sharded_model)

__all__ = ["GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "save_group_sharded_model"]
