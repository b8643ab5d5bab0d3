"""``paddle.distributed.fleet`` of the port (ref:
``python/paddle/distributed/fleet/``): the strategy, the role maker, the
topology, ``fleet.init`` with ``distributed_model`` /
``distributed_optimizer``, the hybrid and sharding optimizers, the
gradient-sync utilities, tensor and sequence parallelism (the mp
layers, ``TensorParallel``, sep / cp attention), pipeline parallelism
(``LayerDesc``, ``SharedLayerDesc``, ``PipelineLayer``,
``PipelineParallel`` and the pipeline steps) and activation recompute
(``recompute``, ``recompute_sequential``, ``recompute_hybrid``), and
``elastic`` (the heartbeat registry and liveness manager the launcher
and ``resilience.run_resilient`` supervise with)."""
from .base.distributed_strategy import DistributedStrategy
from .base.role_maker import PaddleCloudRoleMaker, UserDefinedRoleMaker, Role
from .base.topology import (CommunicateTopology, HybridCommunicateGroup,
                            get_hybrid_communicate_group)
from .fleet import Fleet, fleet
from . import meta_parallel
from .meta_parallel import (LayerDesc, PipelineLayer, PipelineParallel,
                            SharedLayerDesc)
from .meta_optimizers.dygraph_optimizer import (HybridParallelOptimizer,
                                                DygraphShardingOptimizer)
from .recompute import recompute, recompute_sequential, recompute_hybrid
from . import elastic, utils

# module-level singleton API (ref: fleet/__init__.py binds Fleet methods)
init = fleet.init
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_worker = fleet.is_worker
worker_endpoints = fleet.worker_endpoints
server_num = fleet.server_num
barrier_worker = fleet.barrier_worker
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
