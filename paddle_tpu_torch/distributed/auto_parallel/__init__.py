"""``paddle.distributed.auto_parallel`` of the port (ref:
``python/paddle/distributed/auto_parallel/``; counterpart of
``paddle_tpu/distributed/auto_parallel``): ``ProcessMesh`` and the
placements over the port's rank grid, ``shard_tensor`` / ``reshard`` /
``unshard_dtensor`` on each rank's local piece (``get_dist_attr`` and
``global_shape`` read what a distributed tensor records), the rule
table that maps parameter placements onto the port's layers,
``to_static`` / ``DistModel``, ``Strategy`` and ``Engine`` (``fit`` /
``evaluate`` / ``predict`` / ``cost`` / ``tune`` / ``save`` / ``load``
over ``jit.TrainStep`` and ``io.DataLoader``)."""
from .api import (ProcessMesh, Placement, Shard, Replicate, Partial,
                  DistAttr, shard_tensor, dtensor_from_fn, reshard,
                  shard_layer, shard_optimizer, unshard_dtensor,
                  get_mesh, set_mesh, shard_dataloader, to_static,
                  DistModel, get_dist_attr, global_shape)
from .strategy import Strategy
from .engine import Engine
