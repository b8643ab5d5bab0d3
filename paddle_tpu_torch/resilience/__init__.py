"""paddle_tpu_torch.resilience — the shared retry helper
(:func:`~.retry.with_retries`), copied from ``paddle_tpu/resilience/``.
Fault injection, checkpointing and the supervisor are not ported."""
from .retry import deterministic_jitter, with_retries

__all__ = ["with_retries", "deterministic_jitter"]
