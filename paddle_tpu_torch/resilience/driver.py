"""The shared restart backoff of ``paddle_tpu/resilience/driver.py``.

:func:`restart_backoff` is the deterministic exponential backoff before
a relaunch; the fleet's replica supervisor (``serving.fleet.replica``)
uses it, as the reference's supervisor does, so chaos runs reproduce.

Not ported yet: ``ResilientTrainLoop`` and ``run_resilient``, the
training driver's worker and supervisor.  They stand on the distributed
layer (``distributed.fleet.elastic`` liveness and
``distributed.checkpoint``), which waits for its own slice.
"""
from __future__ import annotations

__all__ = ["restart_backoff"]


def restart_backoff(restarts: int, base_delay: float,
                    max_delay: float) -> float:
    """Deterministic exponential backoff before the ``restarts``-th
    relaunch — shared by the fleet replica supervisor
    (``serving.fleet.replica``) so chaos runs reproduce."""
    return min(float(max_delay),
               float(base_delay) * (2 ** (max(int(restarts), 1) - 1)))
