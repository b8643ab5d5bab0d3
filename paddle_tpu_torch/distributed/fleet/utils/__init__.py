"""Fleet utilities: the manual gradient sync and parameter broadcasts."""
from . import hybrid_parallel_util
from .hybrid_parallel_util import fused_allreduce_gradients
