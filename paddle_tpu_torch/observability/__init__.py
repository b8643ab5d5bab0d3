"""paddle_tpu_torch.observability — metrics, events, request traces and
the lock sanitizer; copies of the jax-free modules of
``paddle_tpu/observability/``.

* :mod:`~.metrics` — the process-wide metrics registry (counters /
  gauges / fixed-bucket histograms; thread-safe, labelled) with
  Prometheus-text and JSON snapshot exporters; what ``GET /metrics``
  serves.
* :mod:`~.events` — the append-only JSONL event log, enabled by
  ``FLAGS_observability_dir``.
* :mod:`~.tracing` — per-request traces (W3C ``traceparent`` in/out,
  spans riding the event envelope) and the flight recorder.
* :mod:`~.watchdog` — the SLO regression gate over per-kind duration
  baselines, or against the learned perf model's predictions
  (``model_check``, ``perf_regression`` events).
* :mod:`~.lockwatch` — the lock-graph sanitizer behind
  ``FLAGS_lock_sanitizer``.

CLI: ``python -m paddle_tpu_torch.observability
{snapshot,tail,report,trace,watchdog}`` (exit 3 on a regression).
"""
from . import metrics  # noqa: F401
from . import events   # noqa: F401
from . import tracing  # noqa: F401
from . import watchdog  # noqa: F401
from . import lockwatch  # noqa: F401
from .lockwatch import (LockOrderError, make_lock, make_rlock,  # noqa: F401
                        make_condition, reset_lockwatch)
from .metrics import (counter, gauge, histogram, default_registry,  # noqa: F401
                      HistogramValue, MetricsRegistry)
from .events import emit, span, read_events, EVENT_SCHEMA  # noqa: F401
from .tracing import (start_span, trace_span, parse_traceparent,  # noqa: F401
                      format_traceparent, dump_flight, flight_snapshot)

__all__ = ["metrics", "events", "tracing", "watchdog", "counter", "gauge",
           "histogram", "default_registry", "HistogramValue",
           "MetricsRegistry", "emit", "span", "read_events",
           "EVENT_SCHEMA", "start_span", "trace_span",
           "parse_traceparent", "format_traceparent", "dump_flight",
           "flight_snapshot", "lockwatch", "LockOrderError",
           "make_lock", "make_rlock", "make_condition",
           "reset_lockwatch"]
