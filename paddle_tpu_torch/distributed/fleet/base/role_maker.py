"""Role makers; a copy of ``paddle_tpu/distributed/fleet/base/
role_maker.py`` (ref: fleet/base/role_maker.py PaddleCloudRoleMaker).

Parses the launcher's environment contract into a worker identity: one
worker per process, one process per card.
"""
from __future__ import annotations

import os
from typing import List


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class PaddleCloudRoleMaker:
    def __init__(self, is_collective: bool = True, **kwargs):
        self._is_collective = is_collective
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._size = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = eps.split(",") if eps else ["127.0.0.1:0"]
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT",
                                           self._worker_endpoints[0]
                                           if self._worker_endpoints else "")

    def _generate_role(self):
        return None

    def _role(self):
        return Role.WORKER

    def _worker_index(self) -> int:
        return self._rank

    def _worker_num(self) -> int:
        return self._size

    def _is_first_worker(self) -> bool:
        return self._rank == 0

    def _get_trainer_endpoints(self) -> List[str]:
        return list(self._worker_endpoints)

    def _is_worker(self) -> bool:
        return True

    def _is_server(self) -> bool:
        return False

    worker_index = _worker_index
    worker_num = _worker_num
    is_first_worker = _is_first_worker
    is_worker = _is_worker
    is_server = _is_server


UserDefinedRoleMaker = PaddleCloudRoleMaker
