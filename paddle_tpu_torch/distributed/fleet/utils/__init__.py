"""Fleet utilities: the manual gradient sync, the parameter broadcasts,
sequence parallelism and the ``recompute`` re-export."""
from . import hybrid_parallel_util, sequence_parallel_utils
from .hybrid_parallel_util import fused_allreduce_gradients
from ..recompute import recompute
