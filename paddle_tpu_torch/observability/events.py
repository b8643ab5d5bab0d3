"""Structured run telemetry — append-only JSONL event log; a copy of
``paddle_tpu/observability/events.py``.

One flag (``FLAGS_observability_dir``) turns the event log on: the
serving engine's ``serving_admit`` / ``batch_step`` / ``evict`` /
``request_cancelled`` records, the HTTP server's ``serving`` lifecycle
and the request traces' ``trace_span`` records (``tracing.py``) all
land in ``<dir>/events.jsonl`` as independent JSON lines:

    {"v": 1, "ts": <unix>, "pid": <pid>, "run": "<run-id>",
     "kind": "<kind>", ...kind fields...}

Writes are line-atomic appends under a process lock; readers
(:func:`read_events`) tolerate a corrupt tail — a crash mid-line costs
that line, never the log.  Files rotate at ``rotate_bytes`` into
``events-<k>.jsonl`` (bounded count).

:func:`span` wraps the block in a ``torch.profiler.record_function``
named ``obs:<kind>#<span_id>`` and stamps the same ``span_id`` into the
JSONL record, so an event row can be matched to its span in a
``torch.profiler`` trace.

When the flag is unset every entry point is one ``is None`` check.

Not ported: the JAX package's ``jax.monitoring`` compile listener and
its op-dispatch / host-transfer counting hook (``dispatch_summary``
records); the port has no dispatch layer to hook.  ``EVENT_SCHEMA`` is
the reference's table, kinds of unported subsystems included, so logs
of both packages parse alike.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["configure", "enabled", "emit", "span", "EventLog",
           "read_events", "EVENT_SCHEMA", "ENVELOPE_FIELDS", "log_dir"]

SCHEMA_VERSION = 1

# Envelope stamped on every record by the writer (span_id/dur_s are
# added by :class:`span` regardless of kind; trace_id/span/parent are
# the distributed-tracing fields — stamped explicitly by emitters or
# implicitly from the ambient tracing context, see tracing.py).
ENVELOPE_FIELDS: Dict[str, str] = {
    "v": "int", "ts": "float", "pid": "int", "run": "str", "kind": "str",
    "span_id": "int", "dur_s": "float",
    "trace_id": "str", "span": "str", "parent": "str",
}

# kind -> {field: type}.  Every field an emitter may pass; emitters may
# omit fields (None values are dropped) but may not invent new ones —
# the PTL502 schema gate holds call sites to this table.
EVENT_SCHEMA: Dict[str, Dict[str, str]] = {
    # one training step completed (TrainerCallback / ResilientTrainLoop)
    "step": {"step": "int", "epoch": "int", "loss": "float",
             "step_time_s": "float", "examples_per_sec": "float",
             "grad_norm": "float", "lr": "float"},
    # a jit-cache miss paid trace+compile (TrainStep) or a backend
    # compile measured by jax.monitoring
    "compile": {"source": "str", "event": "str", "dur_s": "float",
                "key": "str"},
    # checkpoint lifecycle (distributed.checkpoint)
    "ckpt_save": {"dur_s": "float", "path": "str", "version": "str",
                  "async_save": "bool", "arrays": "int"},
    "ckpt_commit": {"dur_s": "float", "path": "str"},
    "ckpt_restore": {"dur_s": "float", "path": "str", "version": "str",
                     "committed": "bool", "skipped": "int"},
    # a scheduled fault fired (resilience.faults)
    "fault": {"point": "str", "occurrence": "int", "fault_kind": "str",
              "arg": "str"},
    # the supervisor relaunched (or gave up on) a worker
    "elastic_restart": {"reason": "str", "restarts": "int", "code": "int"},
    "preempt": {"grace_s": "float"},
    # tuning-cache traffic + cost-model refits (paddle_tpu.tuning)
    "tuning_cache": {"cache_kind": "str", "event": "str"},
    "tuning_fit": {"samples": "int", "alphas": "object"},
    # aggregated op-dispatch + host-transfer counts since the last
    # summary
    "dispatch_summary": {"ops": "object", "total": "int",
                         "host_transfers": "int", "window_s": "float"},
    # one program-optimization pass applied to a captured Program
    # (static/passes.run_program_passes) or verified against the
    # randomized corpus (analysis.pass_check): op-count + op-class
    # deltas are the graph features the learned perf model trains on
    "graph_pass": {"pass_name": "str", "program": "str",
                   "ops_before": "int", "ops_after": "int",
                   "removed": "int", "hints": "int",
                   "op_class_delta": "object", "allclose": "bool"},
    # inference server lifecycle (per-request traffic lives in metrics)
    "serving": {"action": "str", "url": "str"},
    # continuous-batching engine (paddle_tpu.serving): a request joined
    # the running batch (possibly resuming after eviction);
    # predicted_cost_s is the learned perf model's batch-step estimate
    # when predicted-cost admission is active
    "serving_admit": {"request": "str", "prompt_len": "int",
                      "cached_tokens": "int", "queue_s": "float",
                      "resumed": "bool", "predicted_cost_s": "float"},
    # one ragged batch iteration (mixed prefill+decode, one launch);
    # step_s + page_occupancy make each record a (features, seconds)
    # training sample for the learned perf model
    "batch_step": {"batch": "int", "prefill_seqs": "int",
                   "decode_seqs": "int", "q_width": "int",
                   "tokens": "int", "queue_depth": "int",
                   "step_s": "float", "page_occupancy": "float",
                   "cold_start": "bool", "fused_steps": "int",
                   "exit_reason": "str"},
    # learned performance model lifecycle (tuning.learned): a versioned
    # model file was fitted/saved from accumulated telemetry
    "perf_model": {"action": "str", "version": "int", "heads": "object",
                   "samples": "object", "path": "str"},
    # observed durations diverged from the learned model's prediction
    # (observability.watchdog.model_check — the divergence gate)
    "perf_regression": {"key": "str", "observed_p50": "float",
                        "predicted_p50": "float", "ratio": "float",
                        "n": "int", "tolerance": "float",
                        "model_version": "int"},
    # a running sequence was preempted for pages and requeued
    "evict": {"request": "str", "kv_len": "int", "n_generated": "int",
              "reason": "str"},
    # one generate() call routed through the mega-kernel decode gate
    # (models/generation): which engine ran and why
    "decode_loop": {"model": "str", "batch": "int", "prompt_len": "int",
                    "max_new_tokens": "int", "generated": "int",
                    "strategy": "str", "compiled": "bool",
                    "fallback": "str"},
    # one closed tracing span (observability.tracing): trace_id/span/
    # parent ride the envelope; `links` names OTHER traces' contexts a
    # shared span (e.g. one ragged batch iteration) served
    "trace_span": {"name": "str", "status": "str", "start_ts": "float",
                   "attrs": "object", "links": "object"},
    # fleet router placement (serving.fleet.router): one routing
    # decision — which replica got the request and why (affinity pages
    # matched, merged-perf-model cost estimate, queue depth at
    # placement); resubmitted marks a failover leg after a replica
    # died mid-stream (generated-so-far tokens kept)
    "router_route": {"request": "str", "replica": "str",
                     "affinity_pages": "int",
                     "predicted_cost_s": "float",
                     "queue_depth": "int", "resubmitted": "bool",
                     "candidates": "int"},
    # the replica supervisor (serving.fleet.replica) relaunched (or
    # gave up on / rolling-restarted) one engine process
    "replica_restart": {"replica": "str", "reason": "str",
                        "restarts": "int", "code": "int",
                        "url": "str"},
    # fault containment (serving.engine): a poisoned request was
    # isolated by bisection / the NaN-logits sentinel and quarantined
    # (action="quarantined"), or a repeat offender was rejected at
    # admission by prompt hash (action="rejected")
    "quarantine": {"request": "str", "reason": "str",
                   "prompt_hash": "str", "action": "str",
                   "batch": "int"},
    # the hung-step watchdog expired a device dispatch: flight recorder
    # dumped, loop thread abandoned (epoch bumped), survivors requeued
    # at the queue front for token-exact resume
    "step_timeout": {"engine": "str", "age_s": "float",
                     "timeout_s": "float", "batch": "int",
                     "relaunches": "int"},
    # a request was cancelled mid-flight (client disconnect, stream/
    # wait consumer timeout, deadline expiry) — pages and batch slot
    # freed immediately
    "request_cancelled": {"request": "str", "reason": "str",
                          "n_tokens": "int", "deadline_s": "float"},
    # the engine health state machine moved (ok -> degraded ->
    # quarantining -> failed and back); the value is exported as the
    # paddle_serving_engine_health gauge the fleet router consumes
    "health_transition": {"engine": "str", "previous": "str",
                          "state": "str", "reason": "str"},
    # the collective sanitizer (distributed.communication.sanitizer)
    # caught two ranks disagreeing on a collective fingerprint —
    # emitted BEFORE the raise so the watchdog and flight recorder see
    # the would-be hang even if the raise is swallowed upstream
    "collective_mismatch": {"op": "str", "group": "str", "seq": "int",
                            "rank_a": "int", "rank_b": "int",
                            "fingerprint_a": "str",
                            "fingerprint_b": "str", "nranks": "int"},
    # the lock sanitizer (observability.lockwatch) saw a wait or hold
    # on an instrumented serving-tier lock cross its threshold —
    # phase="wait" carries wait_s, phase="hold" carries held_s; site is
    # the file:line that acquired the lock
    "lock_contention": {"lock": "str", "phase": "str", "site": "str",
                        "wait_s": "float", "held_s": "float",
                        "thread": "str"},
}

_lock = threading.Lock()
_LOG: Optional["EventLog"] = None
_SPAN_IDS = itertools.count(1)
# distributed-tracing integration (tracing.py registers both at import):
# the provider returns envelope fields to stamp on records emitted
# inside an active span; sinks see every record (the flight ring)
_CTX_PROVIDER: Optional[Callable[[], Optional[Dict[str, Any]]]] = None
_WRITE_SINKS: List[Callable[[Dict[str, Any]], None]] = []
_SELF_METRICS: Optional[Dict[str, Any]] = None


def _log_metrics() -> Optional[Dict[str, Any]]:
    """Self-health counters for the event log itself (records/bytes/
    rotations/dropped writes), registered lazily on the shared metrics
    registry so ``GET /metrics`` can see when the log is degrading.
    None during package bootstrap (metrics not importable yet)."""
    global _SELF_METRICS
    if _SELF_METRICS is None:
        try:
            from . import metrics
        except ImportError:
            return None
        _SELF_METRICS = {
            "records": metrics.counter(
                "paddle_observability_log_records_total",
                "event records appended to the JSONL log"),
            "bytes": metrics.counter(
                "paddle_observability_log_bytes_total",
                "bytes appended to the JSONL log"),
            "rotations": metrics.counter(
                "paddle_observability_log_rotations_total",
                "size-based rotations of events.jsonl"),
            "dropped": metrics.counter(
                "paddle_observability_log_dropped_writes_total",
                "event records lost to write errors (disk full, "
                "permissions)"),
        }
    return _SELF_METRICS


def set_context_provider(fn: Optional[Callable[[], Optional[Dict[str,
                                                                 Any]]]]
                         ) -> None:
    global _CTX_PROVIDER
    _CTX_PROVIDER = fn


def add_write_sink(fn: Callable[[Dict[str, Any]], None]) -> None:
    if fn not in _WRITE_SINKS:
        _WRITE_SINKS.append(fn)


class EventLog:
    """Append-only JSONL writer with size-based rotation."""

    def __init__(self, directory: str, rotate_bytes: int = 32 << 20,
                 keep_rotated: int = 4):
        self.directory = os.path.abspath(directory)
        self.rotate_bytes = int(rotate_bytes)
        self.keep_rotated = int(keep_rotated)
        self.path = os.path.join(self.directory, "events.jsonl")
        self._lock = threading.Lock()
        self.run_id = os.environ.get("PADDLE_OBS_RUN_ID") or \
            f"{os.getpid()}-{int(time.time() * 1000)}"
        self.dropped_writes = 0

    # -- rotation ---------------------------------------------------------
    def _rotated_name(self, k: int) -> str:
        return os.path.join(self.directory, f"events-{k}.jsonl")

    def _maybe_rotate_locked(self) -> None:
        try:
            if os.path.getsize(self.path) < self.rotate_bytes:
                return
        except OSError:
            return
        mets = _log_metrics()
        if mets is not None:
            mets["rotations"].inc()
        # shift events-(k) -> events-(k+1), dropping the oldest
        for k in range(self.keep_rotated - 1, 0, -1):
            src, dst = self._rotated_name(k), self._rotated_name(k + 1)
            if os.path.exists(src):
                if k + 1 > self.keep_rotated - 1:
                    try:
                        os.unlink(src)
                    except OSError:
                        pass
                else:
                    os.replace(src, dst)
        try:
            os.replace(self.path, self._rotated_name(1))
        except OSError:
            pass

    # -- writing ----------------------------------------------------------
    def write(self, kind: str, fields: Dict[str, Any]) -> None:
        rec = {"v": SCHEMA_VERSION, "ts": time.time(), "pid": os.getpid(),
               "run": self.run_id, "kind": kind}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        prov = _CTX_PROVIDER
        if prov is not None and "trace_id" not in rec:
            ctx = prov()
            if ctx:
                for k, v in ctx.items():
                    rec.setdefault(k, v)
        for sink in _WRITE_SINKS:       # the flight-recorder ring
            try:
                sink(rec)
            except Exception:
                pass                    # telemetry must never raise
        line = json.dumps(rec, sort_keys=True, default=str) + "\n"
        mets = _log_metrics()
        with self._lock:
            try:
                os.makedirs(self.directory, exist_ok=True)
                self._maybe_rotate_locked()
                with open(self.path, "a", encoding="utf-8") as fh:
                    fh.write(line)
                if mets is not None:
                    mets["records"].inc()
                    mets["bytes"].inc(len(line))
            except OSError:
                # telemetry must never take the training run down; the
                # drop is visible in the counters (instance + registry)
                self.dropped_writes += 1
                if mets is not None:
                    mets["dropped"].inc()

    def files_oldest_first(self) -> List[str]:
        out = [self._rotated_name(k)
               for k in range(self.keep_rotated, 0, -1)
               if os.path.exists(self._rotated_name(k))]
        if os.path.exists(self.path):
            out.append(self.path)
        return out


# ---------------------------------------------------------------------------
# module-level surface (what the flag + every subsystem use)
# ---------------------------------------------------------------------------

def configure(directory: Optional[str],
              rotate_bytes: Optional[int] = None) -> None:
    """(Re)target the process event log; None/'' disables it.  Called by
    the ``FLAGS_observability_dir`` on_change hook, so env ingestion at
    import wires worker processes automatically."""
    global _LOG
    with _lock:
        if not directory:
            _LOG = None
            return
        kw = {} if rotate_bytes is None else \
            {"rotate_bytes": int(rotate_bytes)}
        _LOG = EventLog(directory, **kw)


def enabled() -> bool:
    return _LOG is not None


def log_dir() -> Optional[str]:
    return _LOG.directory if _LOG is not None else None


def emit(kind: str, **fields: Any) -> None:
    """Append one event record; a no-op (one check) when disabled."""
    log = _LOG
    if log is None:
        return
    log.write(kind, fields)


class span:
    """Context manager: time a block, stamp the duration AND a
    ``torch.profiler.record_function`` correlation id into the emitted
    record.

    ::

        with events.span("ckpt_save", path=dest) as sp:
            ...                       # shows as obs:ckpt_save#<id> in
                                      # the chrome trace
    """

    def __init__(self, kind: str, **fields: Any):
        self.kind = kind
        self.fields = fields
        self.span_id: Optional[int] = None
        self._t0 = 0.0
        self._rec = None

    def __enter__(self) -> "span":
        if _LOG is None:
            return self
        self.span_id = next(_SPAN_IDS)
        try:
            from torch.profiler import record_function
            self._rec = record_function(f"obs:{self.kind}#{self.span_id}")
            self._rec.__enter__()
        except Exception:
            self._rec = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.span_id is not None:
            dur = time.perf_counter() - self._t0
            if self._rec is not None:
                try:
                    self._rec.__exit__(None, None, None)
                except Exception:
                    pass
            emit(self.kind, span_id=self.span_id,
                 dur_s=round(dur, 6), **self.fields)
        return False


# ---------------------------------------------------------------------------
# reading (corrupt-tail tolerant)
# ---------------------------------------------------------------------------

def read_events(path: str, kinds: Optional[List[str]] = None
                ) -> List[Dict[str, Any]]:
    """Parse a JSONL event file or an observability dir (rotated files
    merged oldest-first).  Unparsable lines — the torn tail of a
    crashed writer, bit rot — are skipped, never raised."""
    files: List[str]
    if os.path.isdir(path):
        names = sorted(f for f in os.listdir(path)
                       if f.startswith("events") and f.endswith(".jsonl"))
        # events-<k>.jsonl rotate upward: higher k is OLDER
        rotated = sorted((f for f in names if f != "events.jsonl"),
                         key=lambda f: -_rot_index(f))
        files = [os.path.join(path, f) for f in rotated]
        if "events.jsonl" in names:
            files.append(os.path.join(path, "events.jsonl"))
    else:
        files = [path]
    out: List[Dict[str, Any]] = []
    for fp in files:
        try:
            with open(fp, "r", encoding="utf-8", errors="replace") as fh:
                lines = fh.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or "kind" not in rec:
                continue
            if kinds is None or rec["kind"] in kinds:
                out.append(rec)
    return out


def _rot_index(name: str) -> int:
    try:
        return int(name[len("events-"):-len(".jsonl")])
    except ValueError:
        return 0
