"""``paddle.distributed.passes`` of the port: the pass-management API
(``new_pass``, ``PassManager``, ``PassContext``, ``register_pass``) with
the reference's strategy-lowered distributed passes (amp, fp16,
recompute, sharding, gradient merge, pipeline schedules, the fusion
passes) and ``GradientMergeOptimizer``; the program passes of
``static.passes`` register through it."""
from .gradient_merge import GradientMergeOptimizer
from .pass_base import (PASS_REGISTRY, PassBase, PassContext, PassManager,
                        RecomputePass, new_pass, register_pass)

__all__ = ["PassBase", "PassContext", "PassManager", "new_pass",
           "register_pass", "RecomputePass", "PASS_REGISTRY",
           "GradientMergeOptimizer"]
