"""The launcher's environment contract; counterpart of
``paddle_tpu/distributed/env.py``.

One process drives one card, as upstream Paddle does on GPUs.  The
launcher (``python -m paddle_tpu_torch.distributed.launch``) gives each
process ``PADDLE_TRAINER_ID`` (its global rank), ``PADDLE_TRAINERS_NUM``
(the world size), ``PADDLE_MASTER`` (``host:port`` of the rendezvous
store), ``PADDLE_RANK_IN_NODE`` (its local rank) and
``FLAGS_selected_gpus`` (the card it drives, ``cuda:<id>``).  Once
``init_parallel_env`` has run, ranks and sizes come from the process
group instead.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch.distributed as dist

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "is_initialized"]


class ParallelEnv:
    """The environment contract read when it is built (ref:
    ``python/paddle/base/dygraph/parallel.py`` ParallelEnv)."""

    def __init__(self):
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._local_rank = int(os.getenv("PADDLE_RANK_IN_NODE",
                                         str(self._rank)))
        self._device_id = int(os.getenv("FLAGS_selected_gpus",
                                        str(self._local_rank)).split(",")[0])
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._master = os.getenv("PADDLE_MASTER", "")

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def local_rank(self) -> int:
        return self._local_rank

    @property
    def device_id(self) -> int:
        return self._device_id

    @property
    def current_endpoint(self) -> str:
        return self._current_endpoint

    @property
    def trainer_endpoints(self) -> List[str]:
        return self._trainer_endpoints

    @property
    def master(self) -> str:
        return self._master

    nranks = world_size
    dev_id = device_id


class _Runtime:
    """What ``init_parallel_env`` set up in this process: the rendezvous
    store, the backend and the device the collectives run on."""

    def __init__(self, store, backend: str, device):
        self.store = store
        self.backend = backend
        self.device = device


_runtime: Optional[_Runtime] = None


def get_rank(group=None) -> int:
    """This process's global rank, or its rank in ``group``."""
    rank = dist.get_rank() if dist.is_initialized() else ParallelEnv().rank
    if group is not None:
        return group.get_group_rank(rank)
    return rank


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return ParallelEnv().world_size


def is_initialized() -> bool:
    return _runtime is not None and dist.is_initialized()


def _mark_initialized(store, backend: str, device) -> None:
    global _runtime
    _runtime = _Runtime(store, backend, device)


def _clear() -> None:
    global _runtime
    _runtime = None


def runtime() -> Optional[_Runtime]:
    return _runtime
