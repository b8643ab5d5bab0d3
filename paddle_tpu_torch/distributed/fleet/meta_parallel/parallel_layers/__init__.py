"""The tensor-parallel layers, their collectives and RNG streams (ref:
``fleet/meta_parallel/parallel_layers``)."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .random import (RNGStatesTracker, determinate_seed,
                     get_rng_state_tracker, model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "RNGStatesTracker",
           "determinate_seed", "get_rng_state_tracker",
           "model_parallel_random_seed"]
