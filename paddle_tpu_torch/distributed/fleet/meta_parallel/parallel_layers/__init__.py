"""The tensor-parallel layers, their collectives and RNG streams, and
the pipeline layer descriptions (ref:
``fleet/meta_parallel/parallel_layers``)."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .pp_layers import LayerDesc, PipelineLayer, SegmentLayers, SharedLayerDesc
from .random import (RNGStatesTracker, determinate_seed,
                     get_rng_state_tracker, model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "LayerDesc", "ParallelCrossEntropy",
           "PipelineLayer", "SegmentLayers", "SharedLayerDesc",
           "RowParallelLinear", "VocabParallelEmbedding", "RNGStatesTracker",
           "determinate_seed", "get_rng_state_tracker",
           "model_parallel_random_seed"]
