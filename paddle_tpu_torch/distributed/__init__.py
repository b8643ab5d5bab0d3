"""``paddle.distributed`` of the port (ref: ``paddle_tpu/distributed``).

One process per card: ``init_parallel_env`` (or ``fleet.init``) joins
the process group the launcher's environment describes (NCCL on the
card, gloo with ``device="cpu"``); ``communication`` holds the groups,
the store, the collectives and their sanitizer; ``DataParallel`` averages
gradients with a bucketed reducer; ``fleet`` and ``sharding`` add the
hybrid topology and ZeRO stages 1-3; ``launch`` starts and supervises
the ranks (``fleet.elastic`` watches their heartbeats); ``checkpoint``
saves and loads each rank's pieces of the training state, resharding on
load; ``passes`` holds the pass-management API; ``auto_parallel`` the
semi-auto API (``ProcessMesh``, ``shard_tensor``, ``reshard``,
``to_static``, ``Engine``, ...), whose names this package re-exports.
"""
from .env import ParallelEnv, get_rank, get_world_size, is_initialized
from .mesh import (HYBRID_AXES, build_mesh, ensure_mesh, get_mesh,
                   set_mesh)
from .parallel import DataParallel, init_parallel_env, spawn
from .communication.store import Store, TCPStore
from .communication import (Group, ReduceOp, get_group, new_group,
                            destroy_process_group, all_reduce, all_gather,
                            all_gather_object, broadcast,
                            broadcast_object_list, reduce, scatter, gather,
                            scatter_object_list, reduce_scatter, alltoall,
                            alltoall_single, send, recv, isend, irecv,
                            P2POp, batch_isend_irecv, barrier, wait, stream,
                            CollectiveMismatchError, get_sanitizer,
                            reset_sanitizer)
from . import passes


def get_backend() -> str:
    """``"nccl"`` or ``"gloo"``: the backend ``init_parallel_env``
    chose (raises before it ran)."""
    from .env import runtime
    rt = runtime()
    if rt is None:
        raise RuntimeError("the process group is not initialized")
    return rt.backend


# the semi-auto API's names, re-exported from auto_parallel
_SEMI_AUTO = ("shard_tensor", "shard_layer", "shard_optimizer", "reshard",
              "ProcessMesh", "Shard", "Replicate", "Partial",
              "dtensor_from_fn", "shard_dataloader", "to_static",
              "Strategy", "DistAttr", "unshard_dtensor", "DistModel")


def __getattr__(name):
    import importlib
    if name in ("fleet", "launch", "sharding", "checkpoint",
                "auto_parallel"):
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name in _SEMI_AUTO:
        from . import auto_parallel
        return getattr(auto_parallel, name)
    raise AttributeError(f"module '{__name__}' has no attribute '{name}'")
