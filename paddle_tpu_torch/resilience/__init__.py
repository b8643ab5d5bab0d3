"""paddle_tpu_torch.resilience — deterministic fault injection
(:mod:`.faults`, driven by ``FLAGS_fault_schedule``) and the shared
retry helper (:func:`~.retry.with_retries`), copied from
``paddle_tpu/resilience/``, and the restart backoff the fleet's replica
supervisor shares with the training driver
(:func:`.driver.restart_backoff`).  All three are stdlib-only and
import-safe from ``flags.py``.  Checkpointing and the training
supervisor (``ResilientTrainLoop``, ``run_resilient``) wait for the
distributed layer."""
from .faults import (FaultInjector, FaultSpec, InjectedFault,  # noqa: F401
                     get_injector, install_schedule, maybe_fault,
                     parse_schedule)
from . import driver  # noqa: F401
from .retry import deterministic_jitter, with_retries

__all__ = ["FaultInjector", "FaultSpec", "InjectedFault", "get_injector",
           "install_schedule", "maybe_fault", "parse_schedule",
           "with_retries", "deterministic_jitter"]
