"""Affinity-aware fleet router — one ``POST /generate`` front door
over N serving replicas; a copy of ``paddle_tpu/serving/fleet/router.py``.

The router speaks the exact NDJSON contract of
:class:`~paddle_tpu_torch.inference.serving.InferenceServer`'s engine
route,
so every existing client (``generate_http``) points at the fleet
unchanged.  Placement is a scored policy, first signal wins:

1. **prefix-cache affinity** — the chained per-page content hash of
   the prompt (the same key ``prefix_cache.chained_page_keys``
   computes) is looked up in the router's owner map; the replica that
   prefilled those pages serves the request from its cache instead of
   recomputing the prefix.  The router learns ownership from its own
   routing decisions — no replica round-trip.
2. **least predicted cost** — the merged per-replica perf model
   (``perf_merge``) scores a ``batch_step`` at each candidate's
   current queue depth / occupancy; the cheapest replica wins.
3. **least queue depth**, then round-robin — the load-balancing
   floor when no model is available.

Before any of that, **engine health gates the candidate set**: the
poller parses each replica's ``paddle_serving_engine_health`` gauge
(ok/degraded/quarantining/failed), placement prefers the healthiest
rank available, a ``failed`` replica is unroutable entirely and is
handed to the supervisor for a restart (``restart_replica``,
debounced per failure episode) — the fleet drains a sick replica
BEFORE it dies, not after.

Failure semantics lift the scheduler's eviction-resume contract to
the fleet: a replica dying mid-stream (crash, SIGKILL, drain window
expiry) does NOT kill the client stream — the router resubmits the
unfinished request to a survivor with ``prompt + generated-so-far``
as the new prompt and the token budget reduced by what already
streamed, exactly like an evicted sequence re-prefilling.  The client
sees one uninterrupted token stream and a final ``done`` line with
the full token list.

Observability: every hop propagates/echoes W3C ``traceparent`` (the
router opens a ``fleet_request`` span, the replica parents its
``serving_request`` span on it — one tree across process logs);
``GET /metrics`` re-exports each replica's families with a
``replica="<id>"`` label injected, plus the router's own fleet gauges
(live replicas) and counters (routed / resubmitted / affinity hits);
``router_route`` events record every placement decision.
"""
from __future__ import annotations

import http.client
import itertools
import json
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ...observability import events as _events
from ...observability import metrics as _metrics
from ...observability import tracing as _tracing
from ...observability.lockwatch import make_condition, make_lock
from ..prefix_cache import chained_page_keys
from . import perf_merge
from .replica import ReplicaHandle, ReplicaSupervisor

__all__ = ["FleetRouter"]

# network faults a dead/draining replica produces mid-conversation —
# the resubmission trigger (never client errors)
_LEG_ERRORS = (OSError, http.client.HTTPException, ValueError)

_LIVE = _metrics.gauge(
    "paddle_fleet_live_replicas",
    "replicas currently routable (healthy, not draining)",
    labels=("router",))
_ROUTED = _metrics.counter(
    "paddle_fleet_routed_total",
    "requests placed on a replica (legs, incl. resubmissions)",
    labels=("router", "replica"))
_RESUBMITTED = _metrics.counter(
    "paddle_fleet_resubmitted_total",
    "streams transparently moved to a survivor after a replica died "
    "mid-request (generated-so-far tokens kept)",
    labels=("router",))
_AFFINITY = _metrics.counter(
    "paddle_fleet_affinity_hits_total",
    "placements won by prefix-cache affinity (>=1 owned page key)",
    labels=("router",))
_REQUESTS = _metrics.counter(
    "paddle_fleet_requests_total",
    "fleet requests by outcome (served/rejected/error/bad_request)",
    labels=("router", "outcome"))
_REQ_SECONDS = _metrics.histogram(
    "paddle_fleet_request_seconds",
    "wall time of completed fleet /generate requests (all legs)",
    labels=("router",), buckets=_metrics.TIME_BUCKETS)
_TTFT_SECONDS = _metrics.histogram(
    "paddle_fleet_ttft_seconds",
    "fleet time-to-first-token (placement + replica prefill)",
    labels=("router",), buckets=_metrics.TIME_BUCKETS)

_ROUTER_SEQ = itertools.count(1)


def _parse_gauge(text: str, name: str) -> Optional[float]:
    """Sum every series of gauge ``name`` in a Prometheus exposition
    (a replica may label per engine)."""
    total, seen = 0.0, False
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        rest = line[len(name):]
        if rest[:1] not in ("{", " "):
            continue                       # name-prefix collision
        try:
            total += float(line.rsplit(None, 1)[1])
            seen = True
        except (ValueError, IndexError):
            continue
    return total if seen else None


def _relabel(text: str, replica_id: str) -> Iterable[str]:
    """Inject ``replica="<id>"`` into every sample line of a replica's
    exposition; comment lines pass through (the caller dedupes)."""
    label = f'replica="{replica_id}"'
    for line in text.splitlines():
        if not line or line.startswith("#"):
            yield line
            continue
        try:
            series, value = line.rsplit(None, 1)
        except ValueError:
            continue
        if series.endswith("}"):
            yield f"{series[:-1]},{label}}} {value}"
        else:
            yield f"{series}{{{label}}} {value}"


class _StaticEndpoints:
    """Endpoint provider over fixed URLs (no process supervision) —
    unit tests and externally-managed replicas."""

    def __init__(self, urls: Sequence[str]):
        self.replicas: List[ReplicaHandle] = []
        for i, url in enumerate(urls):
            h = ReplicaHandle(str(i), port_file="")
            h.url = url
            h.healthy = True
            self.replicas.append(h)


class FleetRouter:
    """HTTP front-end placing ``/generate`` streams across replicas.

    Pass either a started :class:`ReplicaSupervisor` (the fleet owns
    its processes) or ``replicas=[url, ...]`` (externally managed).
    ``model_dirs`` names each replica's tuning-cache dir; their
    ``perf_model.json`` files are merged (``perf_merge``) and
    refreshed on the poll thread to drive predicted-cost placement.
    """

    def __init__(self, supervisor: Optional[ReplicaSupervisor] = None,
                 *, replicas: Optional[Sequence[str]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 page_size: int = 16,
                 model_dirs: Sequence[str] = (),
                 perf_model=None,
                 poll_interval: float = 0.5,
                 max_in_flight: int = 256,
                 stream_timeout: float = 120.0,
                 connect_timeout: float = 10.0,
                 resubmit_attempts: int = 3,
                 placement_wait_s: float = 10.0,
                 drain_retry_after: float = 1.0,
                 owner_map_size: int = 8192):
        if (supervisor is None) == (replicas is None):
            raise ValueError("FleetRouter needs exactly one of "
                             "supervisor= or replicas=[urls]")
        self.supervisor = supervisor
        self._static = None if supervisor is not None else \
            _StaticEndpoints(replicas or ())
        self.page_size = int(page_size)
        self.model_dirs = tuple(model_dirs)
        self._model = perf_model
        self.poll_interval = float(poll_interval)
        self.max_in_flight = int(max_in_flight)
        self.stream_timeout = float(stream_timeout)
        self.connect_timeout = float(connect_timeout)
        self.resubmit_attempts = int(resubmit_attempts)
        self.placement_wait_s = float(placement_wait_s)
        self.drain_retry_after = float(drain_retry_after)
        rid = str(next(_ROUTER_SEQ))
        self.router_id = rid
        self._g_live = _LIVE.labels(router=rid)
        self._c_resubmitted = _RESUBMITTED.labels(router=rid)
        self._c_affinity = _AFFINITY.labels(router=rid)
        self._c_served = _REQUESTS.labels(router=rid, outcome="served")
        self._c_rejected = _REQUESTS.labels(router=rid,
                                            outcome="rejected")
        self._c_errors = _REQUESTS.labels(router=rid, outcome="error")
        self._c_bad = _REQUESTS.labels(router=rid,
                                       outcome="bad_request")
        self._h_request = _REQ_SECONDS.labels(router=rid)
        self._h_ttft = _TTFT_SECONDS.labels(router=rid)
        self._routed_children: Dict[str, object] = {}
        # page-key -> replica-id, LRU-bounded: the router's picture of
        # which replica's prefix cache owns which chained keys
        self._owners: "OrderedDict[str, str]" = OrderedDict()
        self._owner_cap = int(owner_map_size)
        self._lock = make_lock("fleet.router._lock")
        self._rr = itertools.count()
        self._req_ids = itertools.count(1)
        self._in_flight = 0
        self._state = make_condition("fleet.router._state")
        self._closing = False
        self._stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        # replicas already handed to the supervisor for a health
        # restart this episode (debounce: the poll loop would
        # otherwise re-fire every interval until the relaunch lands)
        self._health_restarted: set = set()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *a):    # quiet
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
                    body = outer._metrics_text().encode()
                    self._reply(200, body, "text/plain; version=0.0.4")
                elif self.path == "/health":
                    self._reply(200, json.dumps(
                        outer.fleet_stats()).encode())
                else:
                    self._reply(404, b'{"error": "unknown path"}')

            def do_POST(self):
                if self.path != "/generate":
                    self._reply(404, b'{"error": "unknown path"}')
                    return
                if not outer._admit():
                    self._reply(503, json.dumps(
                        {"error": "overloaded: "
                         f"{outer.max_in_flight} requests in flight"}
                    ).encode(), extra_headers=(
                        ("Retry-After",
                         str(outer.drain_retry_after)),))
                    return
                try:
                    with outer._h_request.time():
                        outer._handle_generate(self)
                finally:
                    outer._release()

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    # -- endpoints --------------------------------------------------------
    @property
    def endpoints(self) -> List[ReplicaHandle]:
        src = self.supervisor if self.supervisor is not None \
            else self._static
        return list(src.replicas)

    def _routable(self) -> List[ReplicaHandle]:
        return [h for h in self.endpoints if h.routable()]

    # -- health/stats poller ---------------------------------------------
    def _poll_once(self) -> None:
        live = 0
        for h in self.endpoints:
            url = h.url
            if url is None or h.draining or h.gone:
                h.healthy = False if url is None else h.healthy
                continue
            try:
                with urllib.request.urlopen(
                        url.rstrip("/") + "/metrics",
                        timeout=self.connect_timeout) as resp:
                    text = resp.read().decode("utf-8", "replace")
            except _LEG_ERRORS:
                h.healthy = False
                continue
            qd = _parse_gauge(text,
                              "paddle_serving_engine_queue_depth")
            occ = _parse_gauge(text,
                               "paddle_serving_engine_batch_occupancy")
            h.queue_depth = qd if qd is not None else 0.0
            h.occupancy = occ if occ is not None else 0.0
            # engine health state machine: route around a degraded /
            # quarantining engine BEFORE it dies, and hand a failed
            # one to the supervisor for a restart (debounced — once
            # per failure episode)
            hv = _parse_gauge(text, "paddle_serving_engine_health")
            if hv is None:
                h.health_state = "ok"   # pre-health replica build
            else:
                h.health_state = ("ok", "degraded", "quarantining",
                                  "failed")[min(max(int(hv), 0), 3)]
            if h.health_state == "failed":
                if self.supervisor is not None \
                        and h.id not in self._health_restarted:
                    # restart_replica emits replica_restart
                    # (reason="health") and terminates off-thread
                    self._health_restarted.add(h.id)
                    try:
                        self.supervisor.restart_replica(
                            h.id, reason="health")
                    except KeyError:
                        pass
            else:
                self._health_restarted.discard(h.id)
            h.healthy = True
            if h.health_state != "failed":
                live += 1
        self._g_live.set(live)
        if self.model_dirs:
            merged = perf_merge.merged_from_dirs(self.model_dirs)
            if merged is not None:
                self._model = merged

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            self._poll_once()

    # -- placement policy -------------------------------------------------
    def _prompt_keys(self, prompt: Sequence[int]) -> List[str]:
        return [k for k, _ in chained_page_keys(prompt,
                                                self.page_size)]

    def _affinity(self, keys: Sequence[str], replica_id: str) -> int:
        """Length of the leading run of ``keys`` owned by
        ``replica_id`` — pages the replica can serve from cache."""
        run = 0
        with self._lock:
            for k in keys:
                if self._owners.get(k) != replica_id:
                    break
                run += 1
        return run

    def _predicted_cost(self, h: ReplicaHandle,
                        prompt_len: int) -> Optional[float]:
        model = self._model
        if model is None:
            return None
        occ = float(h.occupancy)
        return model.predict("batch_step", {
            "batch": occ + 1.0, "prefill_seqs": 1.0,
            "decode_seqs": occ, "q_width": float(prompt_len),
            "tokens": occ + float(prompt_len),
            "queue_depth": float(h.queue_depth),
            "page_occupancy": 0.0, "fused_steps": 1.0})

    def _place(self, prompt: Sequence[int],
               exclude: Sequence[str] = ()
               ) -> Optional[Tuple[ReplicaHandle, int,
                                   Optional[float]]]:
        """Pick a replica: ``(handle, affinity_pages,
        predicted_cost_s)`` or None when nothing is routable."""
        cands = [h for h in self._routable()
                 if h.id not in exclude]
        if not cands:
            return None
        # health rank comes FIRST: an ok replica always beats a
        # degraded/quarantining one, whatever affinity or cost says —
        # draining a sick replica of new work is how it heals (and how
        # the blast radius stays contained if it doesn't)
        rank = {"ok": 0, "degraded": 1, "quarantining": 2}
        lo_rank = min(rank.get(h.health_state, 2) for h in cands)
        cands = [h for h in cands
                 if rank.get(h.health_state, 2) <= lo_rank]
        keys = self._prompt_keys(prompt)
        best_aff = 0
        if keys:
            affs = {h.id: self._affinity(keys, h.id) for h in cands}
            best_aff = max(affs.values())
            if best_aff > 0:
                cands = [h for h in cands if affs[h.id] == best_aff]
        costs = {h.id: self._predicted_cost(h, len(prompt))
                 for h in cands}
        if len(cands) > 1 and all(c is not None
                                  for c in costs.values()):
            lo = min(costs[h.id] for h in cands)
            cands = [h for h in cands if costs[h.id] <= lo * 1.001]
        if len(cands) > 1:
            lo_q = min(h.queue_depth for h in cands)
            cands = [h for h in cands if h.queue_depth <= lo_q]
        chosen = cands[next(self._rr) % len(cands)]
        with self._lock:
            for k in keys:
                self._owners[k] = chosen.id
                self._owners.move_to_end(k)
            while len(self._owners) > self._owner_cap:
                self._owners.popitem(last=False)
        if best_aff > 0:
            self._c_affinity.inc()
        return chosen, best_aff, costs.get(chosen.id)

    def _wait_placement(self, prompt: Sequence[int],
                        exclude: Sequence[str] = ()):
        """Placement with a bounded wait — a rolling restart or a
        crash-relaunch window may leave zero routable replicas for a
        moment; callers holding an open client stream would rather
        wait than fail."""
        deadline = time.monotonic() + self.placement_wait_s
        while True:
            placed = self._place(prompt, exclude)
            if placed is not None or \
                    time.monotonic() > deadline:
                return placed
            if not any((not h.gone) and (not h.draining)
                       and h.health_state != "failed"
                       for h in self.endpoints):
                # nothing can become routable without supervisor
                # action (every replica draining / failed / given
                # up): fail FAST with Retry-After instead of holding
                # the client for the full placement window
                return None
            if self._stop.wait(0.1):
                return None

    # -- request proxying -------------------------------------------------
    def _open_leg(self, h: ReplicaHandle, spec: dict,
                  traceparent: Optional[str]):
        headers = {"Content-Type": "application/json"}
        if traceparent:
            headers[_tracing.TRACEPARENT_HEADER] = traceparent
        req = urllib.request.Request(
            (h.url or "").rstrip("/") + "/generate",
            data=json.dumps(spec).encode(), method="POST",
            headers=headers)
        return urllib.request.urlopen(req,
                                      timeout=self.stream_timeout)

    def _routed(self, replica_id: str):
        child = self._routed_children.get(replica_id)
        if child is None:
            child = _ROUTED.labels(router=self.router_id,
                                   replica=replica_id)
            self._routed_children[replica_id] = child
        return child

    def _handle_generate(self, handler) -> None:
        # ---- parse phase: failures are the CLIENT's -> 400
        try:
            n = int(handler.headers.get("Content-Length", "0"))
            spec = json.loads(handler.rfile.read(n) or b"{}")
            ids = spec["input_ids"]
            if not isinstance(ids, list) or not ids:
                raise ValueError("input_ids must be a non-empty "
                                 "list of token ids")
            prompt = [int(t) for t in ids]
            max_new = int(spec.get("max_new_tokens", 32))
            stream = bool(spec.get("stream", True))
        except Exception as e:  # noqa: PTL401, BLE001 — answered to
            # the client as HTTP 400; the router outlives bad input
            self._c_bad.inc()
            handler._reply(400, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode())
            return
        rid = f"f{next(self._req_ids)}"
        client_ctx = _tracing.parse_traceparent(
            handler.headers.get(_tracing.TRACEPARENT_HEADER))
        span = _tracing.start_span("fleet_request", parent=client_ctx,
                                   attrs={"request": rid})
        tp = None
        if span.trace_id is not None:
            tp = _tracing.format_traceparent(span.trace_id,
                                             span.span_id)
        tp_headers = () if tp is None else \
            ((_tracing.TRACEPARENT_HEADER, tp),)
        tokens, err = self._run_legs(
            handler, stream, rid, prompt, max_new, spec,
            tp, tp_headers, span)
        if tokens is None:
            span.end(status="error", error=err)
            return
        span.end(generated=len(tokens))
        if not stream:
            handler._reply(200, json.dumps(
                {"tokens": tokens, "request_id": rid}).encode(),
                extra_headers=tp_headers)

    def _fail(self, handler, started: bool, code: int, msg: str,
              tp_headers, extra=()) -> None:
        """Report a fleet-level failure to the client — as a status
        line while headers are still ours, in-band (the done-line
        protocol) once the stream started."""
        if started:
            self._write_line(handler, {"error": msg})
        else:
            handler._reply(code, json.dumps(
                {"error": msg}).encode(),
                extra_headers=(*extra, *tp_headers))

    def _run_legs(self, handler, stream: bool, rid: str,
                  prompt: List[int], max_new: int, spec: dict,
                  tp: Optional[str], tp_headers, span):
        """Drive the request across replica legs; returns
        ``(tokens, None)`` on success, ``(None, error)`` after the
        failure was reported to the client.  In streaming mode tokens
        are forwarded to the client live, as each leg produces them."""
        got: List[int] = []
        exclude: List[str] = []
        legs = 0
        started = False        # client stream headers on the wire
        ttft_t0 = time.monotonic()
        first_token_seen = False
        while True:
            placed = self._wait_placement(
                prompt if not got else prompt + got, exclude)
            if placed is None:
                msg = "no routable replica"
                if started:
                    self._c_errors.inc()
                else:
                    self._c_rejected.inc()
                self._fail(handler, started, 503, msg, tp_headers,
                           extra=(("Retry-After",
                                   str(self.drain_retry_after)),))
                return None, msg
            h, aff, cost = placed
            legs += 1
            resub = legs > 1
            self._routed(h.id).inc()
            if resub:
                self._c_resubmitted.inc()
            _events.emit("router_route", request=rid, replica=h.id,
                         affinity_pages=aff,
                         predicted_cost_s=cost,
                         queue_depth=int(h.queue_depth),
                         resubmitted=resub,
                         candidates=len(self._routable()),
                         trace_id=span.trace_id, span=span.span_id)
            leg_spec = dict(spec)
            leg_spec["input_ids"] = prompt + got
            leg_spec["max_new_tokens"] = max_new - len(got)
            leg_spec["stream"] = True
            finished = False
            try:
                with self._open_leg(h, leg_spec, tp) as resp:
                    for raw in resp:
                        if not raw.strip():
                            continue
                        row = json.loads(raw)
                        if "error" in row:
                            # in-band replica failure (drain window
                            # expiry, engine stop) — failover
                            break
                        if row.get("done"):
                            finished = True
                            break
                        tok = int(row["token"])
                        got.append(tok)
                        if not first_token_seen:
                            first_token_seen = True
                            self._h_ttft.observe(
                                time.monotonic() - ttft_t0)
                        if stream:
                            if not started:
                                started = self._start_stream(
                                    handler, rid, tp)
                            self._write_line(handler, {"token": tok})
            except urllib.error.HTTPError as e:
                if e.code == 400 and not got:
                    # the replica judged the request malformed (e.g.
                    # prompt too long for its pool) — the client's
                    # fault, not a failover trigger
                    self._c_bad.inc()
                    body = b""
                    try:
                        body = e.read()
                    except _LEG_ERRORS:
                        pass
                    msg = body.decode("utf-8", "replace") or str(e)
                    self._fail(handler, started, 400, msg, tp_headers)
                    return None, msg
                # 503/5xx from the replica: treat as a failed leg
            except _LEG_ERRORS:
                # the replica leg died (connect refused, reset,
                # torn line) — fall through to failover below
                pass
            if finished or len(got) >= max_new:
                # count BEFORE the done line hits the wire: a client
                # that joined on the stream must see the counter moved
                self._c_served.inc()
                if stream:
                    if not started:
                        started = self._start_stream(handler, rid, tp)
                    self._write_line(handler,
                                     {"done": True, "tokens": got,
                                      "request_id": rid})
                return got, None
            # leg failed: route the remainder around the corpse —
            # the eviction-resume contract at fleet level
            h.healthy = False
            exclude = [h.id]
            if legs > self.resubmit_attempts:
                msg = (f"request {rid} failed after {legs} replica "
                       "legs")
                self._c_errors.inc()
                self._fail(handler, started, 502, msg, tp_headers)
                return None, msg

    def _start_stream(self, handler, rid: str,
                      tp: Optional[str]) -> bool:
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("X-Request-Id", rid)
        if tp is not None:
            handler.send_header(_tracing.TRACEPARENT_HEADER, tp)
        handler.end_headers()
        return True

    def _write_line(self, handler, row: dict) -> None:
        try:
            handler.wfile.write(json.dumps(row).encode() + b"\n")
            handler.wfile.flush()
        except OSError:
            pass                      # client hung up mid-stream

    # -- aggregated observability -----------------------------------------
    def _metrics_text(self) -> str:
        """Fleet exposition: each live replica's families with a
        ``replica`` label injected (HELP/TYPE deduped), then the
        router's own registry (fleet gauges/counters/histograms)."""
        lines: List[str] = []
        seen_comments = set()
        for h in self.endpoints:
            url = h.url
            if url is None:
                continue
            try:
                with urllib.request.urlopen(
                        url.rstrip("/") + "/metrics",
                        timeout=self.connect_timeout) as resp:
                    text = resp.read().decode("utf-8", "replace")
            except _LEG_ERRORS:
                continue
            for line in _relabel(text, h.id):
                if line.startswith("#"):
                    if line in seen_comments:
                        continue
                    seen_comments.add(line)
                lines.append(line)
        lines.append(_metrics.default_registry().prometheus_text())
        return "\n".join(lines) + "\n"

    def fleet_stats(self) -> dict:
        reps = [{"id": h.id, "url": h.url, "healthy": h.healthy,
                 "draining": h.draining,
                 "health_state": h.health_state,
                 "queue_depth": h.queue_depth,
                 "occupancy": h.occupancy,
                 "restarts": h.restarts}
                for h in self.endpoints]
        return {"status": "ok", "router": self.router_id,
                "replicas": reps,
                "live": sum(1 for h in self.endpoints
                            if h.routable()),
                "model_version": (self._model.version
                                  if self._model is not None
                                  else None),
                "served": int(self._c_served.value),
                "resubmitted": int(self._c_resubmitted.value),
                "affinity_hits": int(self._c_affinity.value)}

    # -- admission --------------------------------------------------------
    def _admit(self) -> bool:
        with self._state:
            if self._closing or self._in_flight >= self.max_in_flight:
                self._c_rejected.inc()
                return False
            self._in_flight += 1
            return True

    def _release(self) -> None:
        with self._state:
            self._in_flight -= 1
            self._state.notify_all()

    # -- lifecycle --------------------------------------------------------
    @property
    def url(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self) -> "FleetRouter":
        self._poll_once()
        self._poll_thread = threading.Thread(target=self._poll_loop,
                                             name="fleet-router-poll",
                                             daemon=True)
        self._poll_thread.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        _events.emit("serving", action="router_start", url=self.url)
        return self

    def stop(self, drain_timeout: float = 10.0) -> None:
        with self._state:
            self._closing = True
        self._stop.set()
        self._httpd.shutdown()
        deadline = time.monotonic() + float(drain_timeout)
        with self._state:
            while self._in_flight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._state.wait(remaining)
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)
        _events.emit("serving", action="router_stop", url=self.url)

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
