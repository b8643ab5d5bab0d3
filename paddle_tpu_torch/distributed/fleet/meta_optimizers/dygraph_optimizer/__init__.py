from .hybrid_parallel_optimizer import (HybridParallelOptimizer,
                                        DygraphShardingOptimizer)
