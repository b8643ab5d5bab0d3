from .group_sharded import (GroupShardedStage2, GroupShardedStage3,
                            group_sharded_parallel, save_group_sharded_model)
