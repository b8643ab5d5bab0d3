"""Shared retry-with-backoff helper; a copy of
``paddle_tpu/resilience/retry.py``.

The port's HTTP client (``inference.serving.generate_http``) retries
through it, as every I/O edge of the JAX package does, so backoff is
uniform and *deterministic*: the jitter is hashed from ``(label, seed,
attempt)``, never drawn from a live RNG, which keeps chaos tests and
multi-process races reproducible.

The exception filter is typed: only matching exceptions are retried,
anything else propagates immediately (swallow-and-retry on arbitrary
errors is exactly the anti-pattern PTL401 exists to kill).
"""
from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Optional, Tuple, Type, Union

__all__ = ["with_retries", "deterministic_jitter"]

RetryFilter = Union[Type[BaseException], Tuple[Type[BaseException], ...],
                    Callable[[BaseException], bool]]


def deterministic_jitter(label: str, seed: int, attempt: int) -> float:
    """A stable fraction in [0, 1) from (label, seed, attempt) — the
    same call sites back off identically across runs and processes."""
    h = hashlib.sha256(
        f"{label}:{seed}:{attempt}".encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


def _matches(exc: BaseException, retry_on: RetryFilter) -> bool:
    if isinstance(retry_on, (type, tuple)):
        return isinstance(exc, retry_on)
    return bool(retry_on(exc))


def with_retries(fn: Callable[[], Any], *,
                 attempts: int = 3,
                 retry_on: RetryFilter = (OSError,),
                 base_delay: float = 0.05,
                 max_delay: float = 2.0,
                 jitter: float = 0.5,
                 seed: int = 0,
                 label: str = "",
                 sleep: Callable[[float], None] = time.sleep,
                 on_retry: Optional[Callable[[int, BaseException, float],
                                             None]] = None,
                 delay_from: Optional[Callable[[BaseException],
                                               Optional[float]]] = None
                 ) -> Any:
    """Call ``fn()`` up to ``attempts`` times.

    * ``retry_on`` — an exception type / tuple, or a predicate
      ``exc -> bool``.  A non-matching exception propagates immediately
      (no retry); the matching exception of the final attempt propagates
      unwrapped, so callers keep their native error handling.
    * backoff — ``base_delay * 2**(attempt-1)`` capped at ``max_delay``,
      scaled by ``1 + jitter * deterministic_jitter(label, seed,
      attempt)``: exponential, bounded, reproducible.
    * ``delay_from`` — server-directed backoff: when it returns a
      number for the caught exception (e.g. a 503's ``Retry-After``
      header), that exact delay replaces the schedule for this attempt
      (no cap, no jitter — the server's word beats the client's guess).
    * ``sleep`` / ``on_retry`` — injectable for tests and for callers
      that want to log each retry.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:
            if attempt >= attempts or not _matches(e, retry_on):
                raise
            directed = delay_from(e) if delay_from is not None else None
            if directed is not None:
                delay = max(float(directed), 0.0)
            else:
                delay = min(max_delay, base_delay * (2 ** (attempt - 1)))
                delay *= 1.0 + jitter * deterministic_jitter(
                    label, seed, attempt)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
