"""Fleet's parallel wrappers: the tensor-parallel layers and wrappers,
sep / cp attention, the group-sharded stages 1 to 3 (``sharding``) and
pipelines (``PipelineLayer``, ``PipelineParallel``, the schedules and
the pipeline steps)."""
from . import (parallel_layers, pipeline_parallel, pp_schedules, pp_spmd,
               segment_parallel, sharding, tensor_parallel)
from .parallel_layers import (ColumnParallelLinear, LayerDesc,
                              ParallelCrossEntropy, PipelineLayer,
                              RowParallelLinear, SegmentLayers,
                              SharedLayerDesc, VocabParallelEmbedding,
                              get_rng_state_tracker,
                              model_parallel_random_seed)
from .pipeline_parallel import PipelineParallel
from .pp_spmd import PipelineSpmdStep, gpt_pipeline_step
from .tensor_parallel import MetaParallelBase, SegmentParallel, TensorParallel
