"""HTTP serving of the continuous-batching engine; the port of
``paddle_tpu/inference/serving.py``'s ``InferenceServer`` and
``generate_http``.

A threaded stdlib HTTP server:

- ``POST /generate`` — continuous-batching LLM serving, behind
  ``FLAGS_serving_engine`` with a ``paddle_tpu_torch.serving.
  ServingEngine`` attached (the flag off: 404): JSON request
  ``{"input_ids": [...], "max_new_tokens", "eos_token_id",
  "temperature", "deadline_s", "stream"}``.  Streaming responses are
  newline-delimited JSON — one ``{"token": id}`` line per generated
  token as the batch iterations land, closed by ``{"done": true,
  "tokens": [...]}``; ``"stream": false`` returns one JSON body.  A
  client that disconnects mid-stream is detected at the next token
  write and its request cancelled (pages freed immediately).  A request
  the engine rejects at admission answers by its ``error_kind``: a
  doomed ``deadline_s`` or an unhealthy engine **503** with
  ``Retry-After``, a quarantined prompt (and any other rejection)
  **400**.  A field the engine raises ``NotImplementedError`` on answers
  **501** with the engine's message (every field above is honoured).
- ``POST /predict`` — **501**: the port has no ``Predictor`` (the
  ``jit.save`` artifact runtime), so ``InferenceServer(predictor=...)``
  raises ``NotImplementedError``.
- ``GET /health`` — JSON with the engine's stats and the serving
  counters (served / in_flight / rejected / errors / bad_requests).
- ``GET /metrics`` — Prometheus text exposition of the process metrics
  registry (request counts by outcome, request-latency histogram,
  in-flight gauge, the serving engine's families).
- ``GET /debug/trace`` — the flight recorder's ring of recent events
  and spans (``observability.tracing.flight_snapshot``).

Failure taxonomy (the reference's): a malformed request answers
**400**; more than ``max_in_flight`` concurrent requests answer **503**
with ``Retry-After`` (streams count against the bound); a request the
engine fails (or cannot serve because it is unhealthy) answers 500 /
503; ``stop()`` drains in-flight responses before closing the socket.
A W3C ``traceparent`` header parents the request's root span, and the
response echoes it with the server's root span id.

``generate_http`` retries 503 and connection resets with the shared
``resilience.with_retries`` backoff (deterministic jitter, a 503's
``Retry-After`` honoured).
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..flags import get_flag
from ..observability import metrics as _metrics
from ..observability import events as _events
from ..observability import tracing as _tracing
from ..observability.lockwatch import make_condition
from ..resilience.retry import with_retries

__all__ = ["InferenceServer", "generate_http"]

# one family set for every server in the process; children are labelled
# per server instance so /health stays instance-scoped while GET
# /metrics exposes the whole process
_REQUESTS = _metrics.counter(
    "paddle_serving_requests_total",
    "requests by outcome (served/rejected/error/bad_request)",
    labels=("server", "outcome"))
_LATENCY = _metrics.histogram(
    "paddle_serving_request_latency_seconds",
    "wall time of admitted requests (parse + generate)",
    labels=("server",), buckets=_metrics.TIME_BUCKETS)
_IN_FLIGHT = _metrics.gauge(
    "paddle_serving_in_flight", "admitted requests currently executing",
    labels=("server",))

_SERVER_SEQ = itertools.count(1)


class InferenceServer:
    """Serve a ``ServingEngine`` over HTTP (bounded load, draining stop).

    The reference's signature; ``predictor`` (a ``Predictor`` or its
    ``Config``) raises ``NotImplementedError``: the port has no
    ``jit.save`` artifact runtime yet."""

    def __init__(self, predictor=None, host: str = "127.0.0.1",
                 port: int = 0, max_in_flight: int = 8, engine=None,
                 stream_timeout: float = 120.0):
        if predictor is not None:
            raise NotImplementedError(
                "InferenceServer(predictor=...): the Predictor (jit.save "
                "artifact runtime) is not ported; serve an engine")
        if engine is None:
            raise ValueError("InferenceServer needs an engine")
        # continuous-batching ServingEngine (paddle_tpu_torch.serving) —
        # the /generate route serves from it when FLAGS_serving_engine
        # is on; lifecycle stays the caller's (stop() drains the HTTP
        # streams but does not stop the engine)
        self.engine = engine
        self.stream_timeout = float(stream_timeout)
        self.max_in_flight = int(max_in_flight)
        self._state = make_condition("inference.serving._state")  # in-flight accounting
        self._in_flight = 0
        self._closing = False
        # registry-backed serving counters (atomic under concurrent
        # handler threads — the old plain-int "_errors += 1" raced)
        sid = str(next(_SERVER_SEQ))
        self.server_id = sid
        self._c_served = _REQUESTS.labels(server=sid, outcome="served")
        self._c_rejected = _REQUESTS.labels(server=sid,
                                            outcome="rejected")
        self._c_errors = _REQUESTS.labels(server=sid, outcome="error")
        self._c_bad = _REQUESTS.labels(server=sid, outcome="bad_request")
        self._h_latency = _LATENCY.labels(server=sid)
        self._g_in_flight = _IN_FLIGHT.labels(server=sid)
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # quiet
                pass

            def _reply(self, code, body, ctype="application/json",
                       extra_headers=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra_headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    body = _metrics.default_registry() \
                        .prometheus_text().encode()
                    self._reply(200, body,
                                "text/plain; version=0.0.4")
                    return
                if self.path == "/debug/trace":
                    # on-demand flight-recorder dump: the bounded ring
                    # of recent events/spans, newest last (the same
                    # content a crash/SIGTERM writes to
                    # flight-<pid>.json)
                    self._reply(200, json.dumps(
                        _tracing.flight_snapshot(),
                        default=str).encode())
                    return
                if self.path != "/health":
                    self._reply(404, b'{"error": "unknown path"}')
                    return
                info = {"status": "ok",
                        "inputs": [],
                        "engine": outer.engine.stats(),
                        "served": outer.served,
                        "in_flight": outer._in_flight,
                        "rejected": outer.rejected,
                        "errors": outer.errors,
                        "bad_requests": outer.bad_requests}
                self._reply(200, json.dumps(info).encode())

            def do_POST(self):
                if self.path == "/generate":
                    handler = self._do_generate
                elif self.path == "/predict":
                    self._reply(501, json.dumps(
                        {"error": "POST /predict: the Predictor is not "
                                  "ported"}).encode())
                    return
                else:
                    self._reply(404, b'{"error": "unknown path"}')
                    return
                if not outer._admit():
                    # overloaded (or draining): shed load NOW rather
                    # than queueing unbounded; streaming responses pass
                    # through the same gate, so stop() drains them
                    self._reply(503, json.dumps(
                        {"error": "overloaded: "
                         f"{outer.max_in_flight} requests in flight"}
                    ).encode(), extra_headers=(("Retry-After", "1"),))
                    return
                try:
                    # one latency observation per ADMITTED request,
                    # whatever its outcome (400/500/200 all cost the
                    # client this wall time)
                    with outer._h_latency.time():
                        handler()
                finally:
                    outer._release()

            def _do_generate(self):
                if not get_flag("serving_engine"):
                    outer._c_bad.inc()
                    self._reply(404, json.dumps(
                        {"error": "serving engine not enabled "
                                  "(FLAGS_serving_engine)"}).encode())
                    return
                # ---- parse phase: failures are the CLIENT's -> 400
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    spec = json.loads(self.rfile.read(n) or b"{}")
                    ids = spec["input_ids"]
                    if not isinstance(ids, list) or not ids:
                        raise ValueError("input_ids must be a "
                                         "non-empty list of token ids")
                    kw = {"max_new_tokens":
                          int(spec.get("max_new_tokens", 32)),
                          "temperature":
                          float(spec.get("temperature", 0.0))}
                    if spec.get("eos_token_id") is not None:
                        kw["eos_token_id"] = int(spec["eos_token_id"])
                    if spec.get("deadline_s") is not None:
                        kw["deadline_s"] = float(spec["deadline_s"])
                except Exception as e:  # noqa: PTL401, BLE001 —
                    # answered to the client as HTTP 400
                    outer._c_bad.inc()
                    self._reply(400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())
                    return
                # W3C trace context: a client traceparent parents the
                # request's root span; responses echo the header back
                # with the SERVER root span id so the client can splice
                # its own spans around ours
                ctx = _tracing.parse_traceparent(
                    self.headers.get(_tracing.TRACEPARENT_HEADER))
                try:
                    req = outer.engine.submit(ids, trace=ctx, **kw)
                except NotImplementedError as e:
                    # a field the engine does not support yet: the
                    # engine's own message, and no request was queued
                    outer._c_bad.inc()
                    self._reply(501, json.dumps(
                        {"error": str(e)}).encode())
                    return
                tp = None if req.trace is None else \
                    _tracing.format_traceparent(req.trace.trace_id,
                                                req.trace.span_id)
                tp_headers = () if tp is None else \
                    ((_tracing.TRACEPARENT_HEADER, tp),)
                if req.done and req.error:
                    kind = getattr(req, "error_kind", None)
                    if kind in ("deadline", "unhealthy"):
                        # capacity/health shaped: the request is fine,
                        # the engine can't serve it NOW — 503 so a
                        # retrying client (or the fleet router's
                        # failover legs) tries elsewhere/later
                        outer._c_rejected.inc()
                        self._reply(503, json.dumps(
                            {"error": req.error}).encode(),
                            extra_headers=tp_headers
                            + (("Retry-After", "1"),))
                        return
                    # rejected at admission (too long, queue full,
                    # quarantined prompt): still the request's shape,
                    # not our failure
                    outer._c_bad.inc()
                    self._reply(400, json.dumps(
                        {"error": req.error}).encode(),
                        extra_headers=tp_headers)
                    return
                if not spec.get("stream", True):
                    try:
                        toks = req.wait(timeout=outer.stream_timeout)
                    except Exception as e:  # noqa: PTL401, BLE001 —
                        # reported as HTTP 500; the loop survives
                        outer._c_errors.inc()
                        self._reply(500, json.dumps(
                            {"error": f"{type(e).__name__}: "
                                      f"{e}"}).encode(),
                            extra_headers=tp_headers)
                        return
                    outer._c_served.inc()
                    self._reply(200, json.dumps(
                        {"tokens": toks,
                         "request_id": req.id}).encode(),
                        extra_headers=tp_headers)
                    return
                # ---- streaming: newline-delimited JSON, one line per
                # token as each batch iteration lands; the response is
                # close-delimited (HTTP/1.0) and the final line carries
                # done=true so a truncated stream is detectable
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("X-Request-Id", req.id)
                if tp is not None:
                    self.send_header(_tracing.TRACEPARENT_HEADER, tp)
                self.end_headers()
                try:
                    for tok in req.stream(timeout=outer.stream_timeout):
                        try:
                            self.wfile.write(json.dumps(
                                {"token": int(tok)}).encode() + b"\n")
                            self.wfile.flush()
                        except OSError:
                            # client-disconnect detection: the socket
                            # died mid-stream — cancel NOW so the
                            # engine frees the pages and batch slot
                            # instead of decoding for a ghost
                            outer._c_errors.inc()
                            req.cancel("client disconnected "
                                       "mid-stream")
                            return
                    self.wfile.write(json.dumps(
                        {"done": True, "tokens": req.tokens,
                         "request_id": req.id}).encode() + b"\n")
                    outer._c_served.inc()
                except Exception as e:  # noqa: PTL401, BLE001 —
                    # headers are already on the wire: report the
                    # failure IN-BAND (the done-line protocol) and
                    # keep the serving loop alive
                    outer._c_errors.inc()
                    try:
                        self.wfile.write(json.dumps(
                            {"error": f"{type(e).__name__}: "
                                      f"{e}"}).encode() + b"\n")
                    except OSError:
                        pass            # client already hung up

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    # -- registry-backed counter views ----------------------------------
    @property
    def served(self) -> int:
        return int(self._c_served.value)

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def errors(self) -> int:
        return int(self._c_errors.value)

    @property
    def bad_requests(self) -> int:
        return int(self._c_bad.value)

    # -- in-flight accounting -------------------------------------------
    def _admit(self) -> bool:
        with self._state:
            if self._closing or self._in_flight >= self.max_in_flight:
                self._c_rejected.inc()
                return False
            self._in_flight += 1
            self._g_in_flight.set(self._in_flight)
            return True

    def _release(self):
        with self._state:
            self._in_flight -= 1
            self._g_in_flight.set(self._in_flight)
            self._state.notify_all()

    @property
    def url(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        _events.emit("serving", action="start", url=self.url)
        return self

    def stop(self, drain_timeout: float = 10.0):
        """Stop accepting work, DRAIN in-flight requests (bounded by
        ``drain_timeout``), then close the socket and join the loop."""
        with self._state:
            self._closing = True          # new requests answer 503
        self._httpd.shutdown()            # stop the accept loop
        deadline = time.monotonic() + float(drain_timeout)
        with self._state:
            while self._in_flight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    import warnings
                    warnings.warn(
                        f"InferenceServer.stop: {self._in_flight} "
                        "request(s) still in flight after "
                        f"{drain_timeout}s drain; closing anyway",
                        stacklevel=2)
                    break
                self._state.wait(remaining)
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        _events.emit("serving", action="stop", url=self.url)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# retry-backoff sleep, routed through one module hook so tests can
# observe the exact delays the clients choose (incl. Retry-After)
_retry_sleep = time.sleep


def _retriable_http(exc: BaseException) -> bool:
    """Retry overload shedding (503) and connection resets — the two
    failure modes a resilient deployment produces on purpose (load
    limits, rolling restarts).  4xx/5xx semantics are preserved: a 400
    stays the client's bug and a 500 the server's, neither is retried."""
    import urllib.error
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code == 503
    if isinstance(exc, (ConnectionResetError, ConnectionRefusedError,
                        ConnectionAbortedError, BrokenPipeError)):
        return True
    if isinstance(exc, urllib.error.URLError):
        return isinstance(getattr(exc, "reason", None),
                          (ConnectionResetError, ConnectionRefusedError,
                           ConnectionAbortedError, BrokenPipeError))
    return False


def _retry_after_delay(exc: BaseException) -> Optional[float]:
    """Server-directed backoff: a 503's ``Retry-After`` header
    (delta-seconds form) overrides the client's fixed schedule — the
    server (or the fleet router, while draining a replica) knows when
    capacity returns; guessing earlier just re-sheds the load.
    HTTP-date form and absent/garbled headers fall back to the
    schedule (None)."""
    import urllib.error
    if not (isinstance(exc, urllib.error.HTTPError)
            and exc.code == 503):
        return None
    val = exc.headers.get("Retry-After") if exc.headers else None
    if val is None:
        return None
    try:
        return max(float(val), 0.0)
    except ValueError:
        return None


def generate_http(url: str, input_ids, max_new_tokens: int = 32,
                  eos_token_id: Optional[int] = None,
                  temperature: float = 0.0, timeout: float = 120.0,
                  retries: int = 4, retry_backoff: float = 0.1,
                  traceparent: Optional[str] = None):
    """Streaming client for the engine-mode ``POST /generate`` route:
    a generator yielding token ids as the server's batch iterations
    land.  Connection establishment (incl. the 503 overload answer)
    retries with the shared backoff — honoring a 503's ``Retry-After``
    header as the exact delay when the server sends one; once the
    stream starts, a truncated response (no ``done`` line) raises.

    A W3C ``traceparent`` header always rides the request: the one
    given, else the ambient tracing context, else a fresh trace — so
    the server-side span tree is client-correlatable by default."""
    import urllib.request
    body = {"input_ids": [int(t) for t in np.asarray(
        input_ids).reshape(-1)], "max_new_tokens": int(max_new_tokens),
        "temperature": float(temperature), "stream": True}
    if eos_token_id is not None:
        body["eos_token_id"] = int(eos_token_id)
    data = json.dumps(body).encode()
    if traceparent is None:
        ctx = _tracing.current()
        traceparent = _tracing.format_traceparent(
            ctx.trace_id, ctx.span_id) if ctx is not None else \
            _tracing.format_traceparent(_tracing.new_trace_id(),
                                        _tracing.new_span_id())

    def _connect():
        req = urllib.request.Request(
            url.rstrip("/") + "/generate", data=data, method="POST",
            headers={_tracing.TRACEPARENT_HEADER: traceparent})
        return urllib.request.urlopen(req, timeout=timeout)

    # a 503's Retry-After (the router sets it while draining) beats
    # the fixed schedule — see _retry_after_delay
    resp = with_retries(_connect, attempts=max(1, int(retries)),
                        retry_on=_retriable_http,
                        base_delay=retry_backoff, max_delay=2.0,
                        label="generate_http",
                        sleep=lambda d: _retry_sleep(d),
                        delay_from=_retry_after_delay)
    with resp:
        done = False
        for line in resp:
            if not line.strip():
                continue
            row = json.loads(line)
            if "error" in row:
                raise RuntimeError(f"server error: {row['error']}")
            if row.get("done"):
                done = True
                break
            yield int(row["token"])
    if not done:
        raise RuntimeError("generate stream truncated (no done line)")
