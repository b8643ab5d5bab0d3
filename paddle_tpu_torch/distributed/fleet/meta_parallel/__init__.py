"""Fleet's parallel wrappers: the tensor-parallel layers and wrappers,
sep / cp attention and the group-sharded stages 1 to 3 (``sharding``);
pipelines wait for a later slice."""
from . import parallel_layers, segment_parallel, sharding, tensor_parallel
from .parallel_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                              RowParallelLinear, VocabParallelEmbedding,
                              get_rng_state_tracker,
                              model_parallel_random_seed)
from .tensor_parallel import MetaParallelBase, SegmentParallel, TensorParallel
