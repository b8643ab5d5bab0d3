"""End-to-end request tracing + flight recorder; a copy of
``paddle_tpu/observability/tracing.py`` (stdlib only).

Per-request distributed traces as first-class spans riding the JSONL
event envelope (``events.py``): every span is one ``trace_span`` record
carrying ``trace_id`` / ``span`` / ``parent`` envelope fields, so
traces land in the same rotating log every other event lands in and
are reconstructed from the log alone (:func:`build_trace`,
:func:`render_trace`; the JAX package's ``observability`` CLI is not
ported).

Three surfaces:

* **Spans** — :func:`start_span` / :func:`end <Span.end>` for spans
  that open and close in different places (a queue-wait span opens at
  ``submit()`` and closes at admission, in another thread), and
  :class:`trace_span` as a context manager that ALSO activates the
  span as the ambient context: any ``events.emit`` on the same thread
  inside the block is stamped with the span's ``trace_id``/``span``
  automatically (the ``batch_step`` event inherits its step span this
  way).  Cross-request fan-in uses **links**: a shared span (one
  ragged batch iteration serving N requests) carries a ``links`` list
  naming every member request's context, so each request's timeline
  can pull in the shared steps without owning them.

* **W3C trace context** — :func:`parse_traceparent` /
  :func:`format_traceparent` implement the ``traceparent`` header
  (version 00), so a client span id becomes the server root span's
  parent and responses echo the header back.

* **Flight recorder** — a bounded in-memory ring of the most recent
  event records (every ``events`` write lands here too, spans
  included).  :func:`dump_flight` writes the ring to
  ``flight-<pid>.json`` in the observability dir; the resilience
  hooks call it on SIGTERM preemption and before scheduled
  crash/exit faults, and ``GET /debug/trace`` serves
  :func:`flight_snapshot` on demand.

Everything here is stdlib-only and rides the ``FLAGS_observability_dir``
gate: with the flag unset, :func:`start_span` returns a shared no-op
span and the ring stays empty — the per-call cost is one ``enabled()``
check.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

from . import events as _events

__all__ = ["TraceContext", "Span", "start_span", "trace_span", "current",
           "new_trace_id", "new_span_id", "parse_traceparent",
           "format_traceparent", "TRACEPARENT_HEADER",
           "flight_snapshot", "dump_flight", "set_flight_capacity",
           "trace_records", "build_trace", "render_trace"]

TRACEPARENT_HEADER = "traceparent"


class TraceContext(NamedTuple):
    """One point in a trace: the trace and the span to parent on."""
    trace_id: str
    span_id: str


def new_trace_id() -> str:
    tid = os.urandom(16).hex()
    return tid if tid != "0" * 32 else new_trace_id()


def new_span_id() -> str:
    sid = os.urandom(8).hex()
    return sid if sid != "0" * 16 else new_span_id()


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """W3C ``traceparent`` -> :class:`TraceContext`, or None when the
    header is absent/malformed (a bad header must never fail the
    request — the trace just roots server-side)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or version == "ff" \
            or not _is_hex(version):
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) \
            or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) \
            or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


# ---------------------------------------------------------------------------
# ambient context (thread-local via contextvars)
# ---------------------------------------------------------------------------

_CTX: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("paddle_tpu_torch_trace_ctx", default=None)


def current() -> Optional[TraceContext]:
    """The ambient trace context on this thread (set by an enclosing
    :class:`trace_span` block), or None."""
    return _CTX.get()


def _ambient_fields() -> Optional[Dict[str, Any]]:
    """Envelope fields the event writer stamps on records emitted
    inside an active span (registered with events.set_context_provider)."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span": ctx.span_id}


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NoopSpan:
    """Returned when tracing is disabled: every operation is free."""
    __slots__ = ()
    trace_id = None
    span_id = None
    context = None

    def end(self, status: str = "ok", **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One live span.  ``end()`` emits the ``trace_span`` record (with
    duration) and is idempotent — a second ``end`` is a no-op."""

    __slots__ = ("name", "trace_id", "span_id", "parent", "attrs",
                 "links", "start_ts", "_t0", "_ended")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 links: Optional[List[Dict[str, str]]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent = parent
        self.attrs = dict(attrs) if attrs else {}
        self.links = list(links) if links else None
        self.start_ts = time.time()
        self._t0 = time.perf_counter()
        self._ended = False

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def end(self, status: str = "ok", **attrs: Any) -> None:
        if self._ended:
            return
        self._ended = True
        dur = time.perf_counter() - self._t0
        merged = dict(self.attrs)
        for k, v in attrs.items():
            if v is not None:
                merged[k] = v
        _events.emit("trace_span", name=self.name, status=status,
                     start_ts=round(self.start_ts, 6),
                     attrs=merged or None, links=self.links,
                     trace_id=self.trace_id, span=self.span_id,
                     parent=self.parent, dur_s=round(dur, 6))

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        self.end(status="error" if exc_type is not None else "ok")
        return False


def start_span(name: str, parent=None,
               trace_id: Optional[str] = None,
               attrs: Optional[Dict[str, Any]] = None,
               links: Optional[List[Dict[str, str]]] = None):
    """Open a span.  ``parent`` is a :class:`TraceContext`, a
    :class:`Span`, or None — None uses the ambient context, and when
    that is unset too a NEW trace roots here (``trace_id`` pins it).
    Returns :data:`NOOP_SPAN` when tracing is disabled; the caller must
    ``end()`` the result (PTL503 holds call sites to that)."""
    if not _events.enabled():
        return NOOP_SPAN
    if isinstance(parent, Span):
        parent = parent.context
    if parent is None:
        parent = _CTX.get()
    tid = trace_id or (parent.trace_id if parent else new_trace_id())
    pid = parent.span_id if parent else None
    return Span(name, tid, new_span_id(), parent=pid, attrs=attrs,
                links=links)


class trace_span:
    """Context manager: open a span, ACTIVATE it as the ambient context
    for the block (events emitted inside are stamped with it), and end
    it on exit (status ``error`` when the block raised)."""

    def __init__(self, name: str, parent=None,
                 trace_id: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 links: Optional[List[Dict[str, str]]] = None):
        self._kw = dict(name=name, parent=parent, trace_id=trace_id,
                        attrs=attrs, links=links)
        self._span = None
        self._token = None

    def __enter__(self):
        self._span = start_span(**self._kw)
        if self._span is not NOOP_SPAN:
            self._token = _CTX.set(self._span.context)
        return self._span

    def __exit__(self, exc_type, *exc) -> bool:
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        self._span.end(status="error" if exc_type is not None else "ok")
        return False


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

_FLIGHT_LOCK = threading.Lock()
_FLIGHT: deque = deque(maxlen=512)
_FLIGHT_DROPS = None


def _flight_drop_counter():
    """Ring evictions on the shared registry (event-log self-health:
    a post-mortem older than the ring's reach is silently gone, so
    ``GET /metrics`` should show how fast history is being lost)."""
    global _FLIGHT_DROPS
    if _FLIGHT_DROPS is None:
        try:
            from . import metrics
        except ImportError:
            return None
        _FLIGHT_DROPS = metrics.counter(
            "paddle_observability_flight_ring_dropped_total",
            "flight-recorder ring records evicted before any dump")
    return _FLIGHT_DROPS


def set_flight_capacity(n: int) -> None:
    """Resize the ring (keeps the newest records)."""
    global _FLIGHT
    with _FLIGHT_LOCK:
        _FLIGHT = deque(_FLIGHT, maxlen=max(1, int(n)))


def _record_flight(rec: Dict[str, Any]) -> None:
    ring = _FLIGHT
    if len(ring) == ring.maxlen:
        drops = _flight_drop_counter()
        if drops is not None:
            drops.inc()
    ring.append(rec)                    # deque append is GIL-atomic


def flight_snapshot() -> Dict[str, Any]:
    """The ring's current content (newest last) plus process metadata —
    what ``GET /debug/trace`` serves."""
    with _FLIGHT_LOCK:
        events = list(_FLIGHT)
    return {"pid": os.getpid(), "ts": round(time.time(), 6),
            "capacity": _FLIGHT.maxlen, "count": len(events),
            "events": events}


def dump_flight(reason: str = "manual",
                directory: Optional[str] = None) -> Optional[str]:
    """Write the ring to ``flight-<pid>.json`` (atomic rename) in the
    observability dir; returns the path, or None when tracing is
    disabled and no explicit directory was given.  Called by the
    resilience hooks on preemption and before crash/exit faults."""
    d = directory or _events.log_dir()
    if not d:
        return None
    snap = flight_snapshot()
    snap["reason"] = reason
    path = os.path.join(d, f"flight-{os.getpid()}.json")
    tmp = f"{path}.tmp"
    try:
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(snap, fh, default=str)
        os.replace(tmp, path)
    except OSError:
        return None                     # never take the process down
    return path


# ---------------------------------------------------------------------------
# reconstruction (the `observability trace` CLI + tests)
# ---------------------------------------------------------------------------

def trace_records(records: List[Dict[str, Any]], trace_id: str
                  ) -> List[Dict[str, Any]]:
    return [r for r in records if r.get("trace_id") == trace_id]


def _linked_spans(records: List[Dict[str, Any]], trace_id: str
                  ) -> List[Dict[str, Any]]:
    """Spans from OTHER traces whose ``links`` name this trace (the
    shared batch-step spans serving this request among others)."""
    out = []
    for r in records:
        if r.get("kind") != "trace_span" or r.get("trace_id") == trace_id:
            continue
        for link in r.get("links") or []:
            if isinstance(link, dict) and link.get("trace_id") == trace_id:
                out.append(r)
                break
    return out


def build_trace(records: List[Dict[str, Any]], trace_id: str
                ) -> Dict[str, Any]:
    """Reconstruct one request's span tree from an event stream.

    Returns ``{"trace_id", "roots": [node...], "orphans": [...],
    "linked": [...]}`` where each node is ``{"span": rec,
    "children": [node...], "events": [rec...]}``.  ``linked`` holds
    shared spans (other traces) whose ``links`` reference this trace,
    ts-ordered."""
    mine = trace_records(records, trace_id)
    spans = [r for r in mine if r.get("kind") == "trace_span"]
    nodes = {r["span"]: {"span": r, "children": [], "events": []}
             for r in spans if r.get("span")}
    roots, orphan_events = [], []
    for sid, node in nodes.items():
        parent = node["span"].get("parent")
        if parent and parent in nodes:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)
    for r in mine:
        if r.get("kind") == "trace_span":
            continue
        node = nodes.get(r.get("span"))
        if node is not None:
            node["events"].append(r)
        else:
            orphan_events.append(r)

    def _ts(rec):
        return rec.get("start_ts") or rec.get("ts") or 0.0

    def _sort(node):
        node["children"].sort(key=lambda n: _ts(n["span"]))
        node["events"].sort(key=_ts)
        for c in node["children"]:
            _sort(c)

    roots.sort(key=lambda n: _ts(n["span"]))
    for node in roots:
        _sort(node)
    linked = sorted(_linked_spans(records, trace_id), key=_ts)
    return {"trace_id": trace_id, "roots": roots,
            "orphans": sorted(orphan_events, key=_ts), "linked": linked}


def _fmt_attrs(rec: Dict[str, Any]) -> str:
    attrs = rec.get("attrs") or {}
    skip = {"v", "ts", "pid", "run", "kind", "trace_id", "span",
            "parent", "span_id", "dur_s", "name", "status", "start_ts",
            "attrs", "links"}
    extra = {k: v for k, v in rec.items() if k not in skip}
    extra.update(attrs if isinstance(attrs, dict) else {})
    return " ".join(f"{k}={v}" for k, v in sorted(extra.items()))


def render_trace(records: List[Dict[str, Any]], trace_id: str) -> str:
    """Human timeline of one trace (the ``observability trace``
    output): the span tree indented, point events as ``·`` rows under
    their span, shared linked spans as ``↳`` rows."""
    tree = build_trace(records, trace_id)
    n_spans = sum(1 for r in trace_records(records, trace_id)
                  if r.get("kind") == "trace_span")
    lines = [f"trace {trace_id} — {n_spans} span(s), "
             f"{len(tree['linked'])} linked step(s)"]
    if not tree["roots"] and not tree["orphans"]:
        lines.append("  (no records)")
        return "\n".join(lines)
    t0 = None
    for node in tree["roots"]:
        ts = node["span"].get("start_ts") or node["span"].get("ts")
        if ts is not None:
            t0 = ts if t0 is None else min(t0, ts)

    def _off(rec):
        ts = rec.get("start_ts") or rec.get("ts")
        if ts is None or t0 is None:
            return "      ?"
        return f"+{(ts - t0) * 1000:8.1f}ms"

    def _dur(rec):
        d = rec.get("dur_s")
        return f"{d * 1000:.1f}ms" if isinstance(d, (int, float)) else "?"

    def _walk(node, indent):
        s = node["span"]
        lines.append(f"{_off(s)} {'  ' * indent}{s.get('name', '?')} "
                     f"[{s.get('status', '?')} {_dur(s)}] "
                     f"span={s.get('span')} {_fmt_attrs(s)}".rstrip())
        for ev in node["events"]:
            lines.append(f"{_off(ev)} {'  ' * (indent + 1)}"
                         f"· {ev.get('kind')} {_fmt_attrs(ev)}".rstrip())
        for child in node["children"]:
            _walk(child, indent + 1)

    for node in tree["roots"]:
        _walk(node, 1)
    for ev in tree["orphans"]:
        lines.append(f"{_off(ev)}   · {ev.get('kind')} "
                     f"{_fmt_attrs(ev)}".rstrip())
    for s in tree["linked"]:
        lines.append(f"{_off(s)}   ↳ {s.get('name', '?')} "
                     f"[{s.get('status', '?')} {_dur(s)}] "
                     f"span={s.get('span')} {_fmt_attrs(s)}".rstrip())
    return "\n".join(lines)


# register with the event writer: ambient stamping + the flight ring.
# Import order is safe — events.py is stdlib-only and already imported.
_events.set_context_provider(_ambient_fields)
_events.add_write_sink(_record_flight)
