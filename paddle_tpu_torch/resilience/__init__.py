"""paddle_tpu_torch.resilience — deterministic fault injection
(:mod:`.faults`, driven by ``FLAGS_fault_schedule``) and the shared
retry helper (:func:`~.retry.with_retries`), copied from
``paddle_tpu/resilience/``, and the resilient training driver
(:mod:`.driver`): ``ResilientTrainLoop`` (the worker's restore / save /
``end_step`` with its ``step`` fault point), ``run_resilient`` (the
supervisor) with its ``RunReport``, and the restart backoff the fleet's
replica supervisor shares with it.  All are stdlib-only at import
(``driver`` imports ``distributed.checkpoint`` when a loop restores or
saves), so ``flags.py`` may import them."""
from .faults import (FaultInjector, FaultSpec, InjectedFault,  # noqa: F401
                     get_injector, install_schedule, maybe_fault,
                     parse_schedule)
from . import driver  # noqa: F401
from .driver import (CKPT_DIR_ENV, ResilientTrainLoop, RunReport,
                     restart_backoff, run_resilient)
from .retry import deterministic_jitter, with_retries

__all__ = ["FaultInjector", "FaultSpec", "InjectedFault", "get_injector",
           "install_schedule", "maybe_fault", "parse_schedule",
           "with_retries", "deterministic_jitter", "ResilientTrainLoop",
           "RunReport", "run_resilient", "restart_backoff", "CKPT_DIR_ENV"]
