"""``paddle.distributed.stream`` — stream-controlled collectives (ref:
``python/paddle/distributed/communication/stream/``).  The same ops with
the same signatures: torch orders the communication and compute streams
itself, so ``use_calc_stream`` is accepted and changes nothing."""
from .collective_ops import (all_gather, all_reduce, alltoall,
                             alltoall_single, broadcast, recv, reduce,
                             reduce_scatter, scatter, send)

__all__ = ["all_reduce", "all_gather", "broadcast", "reduce", "scatter",
           "reduce_scatter", "alltoall", "alltoall_single", "send", "recv"]
