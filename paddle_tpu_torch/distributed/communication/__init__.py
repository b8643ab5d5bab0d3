"""Groups, the store, collectives and their sanitizer (ref:
``paddle_tpu/distributed/communication/``)."""
from .group import Group, ReduceOp, get_group, new_group, destroy_process_group
from .collective_ops import (all_reduce, all_gather, all_gather_object,
                             broadcast, broadcast_object_list, reduce,
                             scatter, gather, scatter_object_list,
                             reduce_scatter, alltoall, alltoall_single, send,
                             recv, isend, irecv, P2POp, batch_isend_irecv,
                             barrier, wait)
from .sanitizer import (CollectiveMismatchError, CollectiveSanitizer,
                        Fingerprint, get_sanitizer, reset_sanitizer)
from .store import Store, TCPStore
from . import stream
