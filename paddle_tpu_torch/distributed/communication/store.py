"""The rendezvous key-value store; counterpart of
``paddle_tpu/distributed/communication/store.py``.

:class:`TCPStore` is ``torch.distributed.TCPStore`` behind the
reference's methods: ``get`` (waiting up to ``timeout`` for the key),
``set``, ``add``, ``wait`` (bounded), ``delete_key`` and ``port``.  It is
the store ``init_parallel_env`` gives ``init_process_group``, so the
process group's rendezvous and the collective sanitizer's fingerprint
exchange share it.  A wait that runs out raises ``TimeoutError``, as the
reference's does; every wait is bounded by the store's ``timeout`` when
the call gives none.
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch.distributed as dist

__all__ = ["TCPStore", "Store"]


class Store:
    """ref: phi Store base — get/set/add/wait."""

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def set(self, key: str, value) -> None:
        raise NotImplementedError

    def add(self, key: str, amount: int) -> int:
        raise NotImplementedError

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        raise NotImplementedError


def _delta(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


class TCPStore(Store):
    """ref: ``TCPStore(host, port, is_master, world_size, timeout)``.
    The master serves the store (``port=0`` picks a free port, read back
    from :attr:`port`); the others connect to it, each within
    ``timeout`` seconds."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6170,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 120.0):
        self._timeout = float(timeout)
        self._store = dist.TCPStore(host, int(port), int(world_size),
                                    bool(is_master), _delta(timeout),
                                    wait_for_workers=False)

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._store.set(key, bytes(value))

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        self.wait([key], timeout)
        return self._store.get(key)

    def add(self, key: str, amount: int = 1) -> int:
        return int(self._store.add(key, int(amount)))

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        if isinstance(keys, str):
            keys = [keys]
        t = self._timeout if timeout is None else float(timeout)
        try:
            self._store.wait(list(keys), _delta(t))
        except dist.DistStoreError as e:
            raise TimeoutError(f"TCPStore.wait({list(keys)}) timed out "
                               f"after {t} s") from e

    def delete_key(self, key: str) -> None:
        self._store.delete_key(key)

    @property
    def port(self) -> int:
        return int(self._store.port)

    @property
    def torch_store(self):
        """The ``torch.distributed.Store`` for ``init_process_group``."""
        return self._store
