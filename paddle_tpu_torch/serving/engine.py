"""Continuous-batching serving engine — joins the scheduler, the ragged
paged attention step and the prefix cache into one token-streaming
service; the core of ``paddle_tpu/serving/engine.py``.

One background daemon thread runs the iteration loop: every pass it asks
the scheduler for a :class:`~.scheduler.StepPlan` (admitting / evicting
at token-iteration granularity), runs ONE ragged step for the whole
mixed prefill+decode batch (``models.generation.build_ragged_decode_step``,
whose attention is the hand-written CUDA kernel), samples the next token
per sequence ON THE DEVICE, and reads the sampled row back — the only
device-to-host read of the step.  Admission, eviction and EOS all key
off that read.  The query-chunk width is padded to a power of two
(``_bucket``), as in the JAX engine.  GPT and LLaMA models serve alike:
the layer count comes from the step's params.

With ``FLAGS_serving_fused_steps > 1`` a steady-state decode plan (no
prefill, ``Q == 1``) runs as a window of up to N iterations
(``models.generation.build_fused_window_step``): EOS, budget and the
append cursors stay on the device, and the host reads ONE packed array
per window.  While the device runs it, the scheduler pre-stages the next
boundary's admission (committed or discarded at the next plan).  A
torch window cannot stop on its first finish without a read, so the
iterations left after a finish run and do nothing; ``stats()`` counts
them (``window_idle_iterations``).  Prefill steps, eviction-pressured
steps and ``fused_steps == 1`` keep the single-step path.

Observability, as in the JAX engine: ``serving_admit`` / ``batch_step``
/ ``evict`` / ``request_cancelled`` events, queue-depth and
batch-occupancy gauges, step / end-to-end / time-to-first-token
histograms and token / step / dispatch counters, all on the metrics
registry that ``GET /metrics`` exports; ``submit(trace=...)`` parents a
request's root span (``serving_request``) and its queue-wait span, and
every step or window is one ``batch_step`` span linked from its
requests' traces.

Not ported yet (the fault-containment slice): the hung-step watchdog and
relaunch, quarantine bisection, deadlines and perf-model admission.  A
step or window that raises fails the requests of its batch, loudly; the
engine keeps serving the rest.
"""
from __future__ import annotations

import itertools
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..device import default_device, generator
from ..flags import get_flag
from ..models.generation import serving_sample
from ..observability import events as _events
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..observability.lockwatch import make_condition, make_lock
from ..ops import ragged_paged_attention as _rpa
from .prefix_cache import PrefixCache
from .scheduler import PagePool, Request, Scheduler

__all__ = ["ServingEngine"]

_QUEUE_DEPTH = _metrics.gauge(
    "paddle_serving_engine_queue_depth",
    "requests waiting for a batch slot", labels=("engine",))
_OCCUPANCY = _metrics.gauge(
    "paddle_serving_engine_batch_occupancy",
    "sequences in the running batch", labels=("engine",))
_REQ_LATENCY = _metrics.histogram(
    "paddle_serving_engine_request_seconds",
    "end-to-end request wall time (queue + prefill + decode)",
    labels=("engine",), buckets=_metrics.TIME_BUCKETS)
_TTFT = _metrics.histogram(
    "paddle_serving_engine_ttft_seconds",
    "submit-to-first-token wall time",
    labels=("engine",), buckets=_metrics.TIME_BUCKETS)
_STEP_LATENCY = _metrics.histogram(
    "paddle_serving_engine_step_seconds",
    "one ragged batch iteration or fused window (dispatch + the "
    "boundary read)", labels=("engine",), buckets=_metrics.TIME_BUCKETS)
_TOKENS = _metrics.counter(
    "paddle_serving_engine_tokens_total",
    "tokens processed, by phase (prefill: prompt KV built; decode: "
    "generated)", labels=("engine", "phase"))
_EVICTIONS = _metrics.counter(
    "paddle_serving_engine_evictions_total",
    "running sequences preempted for pages", labels=("engine",))
_STEPS = _metrics.counter(
    "paddle_serving_engine_steps_total",
    "ragged batch iterations executed", labels=("engine",))
_DISPATCHES = _metrics.counter(
    "paddle_serving_engine_dispatches_total",
    "step launches with one host read each (a fused window is ONE "
    "dispatch covering its iterations)", labels=("engine",))
_HEALTH = _metrics.gauge(
    "paddle_serving_engine_health",
    "engine health (0 ok / 3 failed: the loop died or wedged)",
    labels=("engine",))
_CANCELLED = _metrics.counter(
    "paddle_serving_engine_cancelled_total",
    "requests cancelled (client disconnect, consumer timeout)",
    labels=("engine",))

_ENGINE_SEQ = itertools.count(1)
_POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bucket(n: int) -> int:
    """Next power of two >= n — bounds the number of distinct step
    shapes to log2(max prompt length)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def _links(plan):
    """The member requests' trace contexts a shared step span names."""
    links = [{"trace_id": s.req.trace.trace_id, "span": s.req.trace.span_id}
             for s in plan.seqs if s.req.trace is not None]
    return links or None


class ServingEngine:
    """Continuous-batching LLM serving over one model.

    ``submit()`` returns a :class:`~.scheduler.Request` whose
    ``stream()`` yields generated token ids live and whose ``wait()``
    blocks for the full result.  Greedy by default; a per-request
    ``temperature > 0`` samples on the device from the engine's
    ``torch.Generator`` (seeded with ``seed``).  ``dtype`` is the KV
    pools' (``"float32"`` or ``"bfloat16"``).  ``device=None`` means the
    CUDA card and raises without one; the model must already live on
    the engine's device.  Use as a context manager or call
    ``start()``/``stop()``.

    The reference's predicted-cost admission (``perf_model``,
    ``max_step_cost_s``) and its step watchdog
    (``health_recovery_steps``, ``max_watchdog_relaunches``) wait for a
    later slice: a value other than the default raises
    ``NotImplementedError`` (``perf_model="auto"`` loads a model only
    for ``max_step_cost_s > 0``, so it and ``None`` mean none).
    """

    def __init__(self, model, *, max_batch: int = 8, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_pages_per_seq: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 max_queue: int = 1024, max_prefill_chunk: int = 0,
                 prefix_caching: bool = True, seed: int = 0,
                 dtype: str = "float32", perf_model="auto",
                 max_step_cost_s: Optional[float] = None,
                 health_recovery_steps: int = 64,
                 max_watchdog_relaunches: int = 3, device=None):
        if perf_model not in ("auto", None) or max_step_cost_s:
            raise NotImplementedError(
                "predicted-cost admission (perf_model, max_step_cost_s) "
                "waits for a later slice")
        if health_recovery_steps != 64 or max_watchdog_relaunches != 3:
            raise NotImplementedError(
                "the step watchdog (health_recovery_steps, "
                "max_watchdog_relaunches) waits for a later slice")
        self.device = default_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine on {self.device}")
        pool_dtype = _POOL_DTYPES.get(dtype, dtype)
        if pool_dtype not in _POOL_DTYPES.values():
            raise ValueError(f"pool dtype must be float32 or bfloat16, "
                             f"got {dtype!r}")
        model.eval()
        self.model = model
        self._params, self._step_fn = model.build_ragged_decode_step()
        cfg = model.config
        nh = int(cfg.num_heads)
        hd = int(cfg.hidden_size) // nh
        nkv = int(getattr(cfg, "num_kv_heads", nh) or nh)
        self.n_layers = len(self._params["blocks"] if "blocks"
                            in self._params else self._params["layers"])
        ps = int(page_size)
        max_pos = int(getattr(cfg, "max_position_embeddings", 1024))
        if max_pages_per_seq is None:
            max_pages_per_seq = -(-max_pos // ps)
        if num_pages is None:
            # every slot can hold a max-length sequence, plus the sink
            num_pages = int(max_batch) * int(max_pages_per_seq) + 1
        self.pool = PagePool(num_pages, ps)
        self.prefix_cache = PrefixCache(self.pool) if prefix_caching \
            else None
        self.scheduler = Scheduler(
            self.pool, max_batch, max_pages_per_seq,
            prefix_cache=self.prefix_cache, max_queue=max_queue,
            max_prefill_chunk=max_prefill_chunk, max_seq_len=max_pos)
        self.max_batch = int(max_batch)
        self.default_eos = None if eos_token_id is None \
            else int(eos_token_id)
        shape = (nkv, int(num_pages), ps, hd)
        self._pools = [
            (torch.zeros(shape, dtype=pool_dtype, device=self.device),
             torch.zeros(shape, dtype=pool_dtype, device=self.device))
            for _ in range(self.n_layers)]
        self._gen = generator(seed, self.device)
        self._windows: dict = {}    # max_window -> the window function
        self.engine_id = str(next(_ENGINE_SEQ))
        eid = self.engine_id
        self._g_queue = _QUEUE_DEPTH.labels(engine=eid)
        self._g_occ = _OCCUPANCY.labels(engine=eid)
        self._h_latency = _REQ_LATENCY.labels(engine=eid)
        self._h_ttft = _TTFT.labels(engine=eid)
        self._h_step = _STEP_LATENCY.labels(engine=eid)
        self._c_prefill = _TOKENS.labels(engine=eid, phase="prefill")
        self._c_decode = _TOKENS.labels(engine=eid, phase="decode")
        self._c_evict = _EVICTIONS.labels(engine=eid)
        self._c_steps = _STEPS.labels(engine=eid)
        self._c_dispatch = _DISPATCHES.labels(engine=eid)
        self._g_health = _HEALTH.labels(engine=eid)
        self._g_health.set(0)
        self._c_cancelled = _CANCELLED.labels(engine=eid)
        self._lock = make_lock("serving.engine._lock")
        self._wake = make_condition("serving.engine._wake", self._lock)
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._accepting = False
        self.health = "ok"          # "failed" once the loop dies or wedges
        # counters (written by the loop thread under self._lock)
        self._steps = 0             # iterations that ran
        self._dispatches = 0
        self._host_reads = 0        # device reads: one per dispatch
        self._window_idle = 0       # window iterations after a finish
        self._prefill_tokens = 0    # prompt tokens whose KV was built
        self._decode_tokens = 0     # tokens generated
        self._kernel_launches = 0
        self._failed_steps = 0
        self._prefill_steps = 0     # steps that fed any prompt tokens
        self._prefill_step_s = 0.0
        self._decode_step_s = 0.0   # single decode steps and windows
        self._n_cancelled = 0

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ServingEngine":
        with self._wake:
            if self._running:
                return self
            self._running = True
            self._accepting = True
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serving-engine-{self.engine_id}")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0,
             join_timeout: float = 5.0) -> dict:
        """Stop accepting requests; with ``drain`` let every admitted or
        queued request finish first (bounded by ``timeout``), else fail
        them at once; whatever is left then fails.  Join the loop thread
        within ``join_timeout``.  Returns ``{"engine", "health",
        "wedged"}``, the reference's keys: ``wedged`` is True when the
        loop thread is still in a step after ``join_timeout`` (health
        then goes ``"failed"``)."""
        with self._wake:
            self._accepting = False
            self._wake.notify_all()
        if drain:
            deadline = time.monotonic() + float(timeout)
            while time.monotonic() < deadline:
                with self._lock:
                    if not self.scheduler.has_work():
                        break
                time.sleep(0.01)
        with self._wake:
            self._running = False
            self._fail_all_locked("engine stopped")
            self._wake.notify_all()
        wedged = False
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=join_timeout)
            if t.is_alive():
                wedged = True
                warnings.warn(f"serving engine {self.engine_id}: loop "
                              f"thread still in a step after "
                              f"{join_timeout}s", stacklevel=2)
                _tracing.dump_flight("serving_stop_wedged")
                with self._lock:
                    self._set_failed()
        with self._lock:
            health = self.health
        return {"engine": self.engine_id, "health": health,
                "wedged": wedged}

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- request side ----------------------------------------------------
    def submit(self, input_ids, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0,
               request_id: Optional[str] = None,
               trace=None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue one generation request; returns the live handle (whose
        ``id`` is ``request_id`` when given).  ``trace`` is an optional
        :class:`~..observability.tracing.TraceContext` to parent the
        request's root span on (the HTTP layer passes the client's
        ``traceparent`` here); without it a fresh trace roots at this
        request when tracing is enabled (``FLAGS_observability_dir``).
        ``deadline_s`` waits for a later slice and raises
        ``NotImplementedError`` when given."""
        req = Request(input_ids, max_new_tokens=max_new_tokens,
                      eos_token_id=(self.default_eos if eos_token_id
                                    is None else eos_token_id),
                      temperature=temperature, request_id=request_id,
                      deadline_s=deadline_s)
        req._cancel_cb = self._cancel_request
        root = _tracing.start_span(
            "serving_request", parent=trace,
            attrs={"request": req.id, "engine": self.engine_id,
                   "prompt_len": len(req.prompt),
                   "max_new_tokens": req.max_new_tokens})
        if root is not _tracing.NOOP_SPAN:
            req.trace = root.context
            req._root_span = root
            req._queue_span = _tracing.start_span("queue", parent=root)
        with self._wake:
            if not self._accepting:
                if self.health == "failed":
                    req.error_kind = "unhealthy"
                    req._finish(error="engine is unhealthy (failed)")
                else:
                    req._finish(error="engine is not accepting "
                                      "requests")
                return req
            self.scheduler.submit(req)
            self._g_queue.set(self.scheduler.queue_depth())
            self._wake.notify()
        return req

    def _cancel_request(self, req, reason: str) -> None:
        """``Request.cancel()`` hook: routes through the engine lock so
        pages and the batch slot free immediately."""
        with self._wake:
            if req.done:
                return
            self._n_cancelled += 1
            self._c_cancelled.inc()
            _events.emit("request_cancelled", request=req.id,
                         reason=reason, n_tokens=len(req.tokens))
            self.scheduler.drop(req, error=reason)
            self._g_queue.set(self.scheduler.queue_depth())
            self._g_occ.set(len(self.scheduler.running))

    def _fail_all_locked(self, error: str) -> None:
        leftovers = list(self.scheduler.waiting) \
            + list(self.scheduler.running)
        self.scheduler.waiting.clear()
        for seq in leftovers:
            self.scheduler.finish(seq, error=error)
        self._g_queue.set(0)
        self._g_occ.set(0)

    def _set_failed(self) -> None:
        self.health = "failed"
        self._g_health.set(3)

    # -- the iteration loop ----------------------------------------------
    def _loop(self):
        try:
            self._loop_body()
        except Exception as e:  # noqa: BLE001 — last resort: a loop
            # thread dying silently would hang every consumer
            warnings.warn(f"serving engine loop died: "
                          f"{type(e).__name__}: {e}", stacklevel=1)
            with self._wake:
                self._accepting = False
                self._set_failed()
                self._fail_all_locked(f"engine loop failed: "
                                      f"{type(e).__name__}: {e}")

    def _loop_body(self):
        while True:
            with self._wake:
                if not self._running:
                    return
                if not self.scheduler.has_work():
                    self._wake.wait(0.05)
                    continue
                plan, admitted, evicted = self.scheduler.plan_step()
                self._note_admissions_locked(admitted, evicted)
                # fused-window eligibility (the JAX rule): pure
                # steady-state decode only, no prefill chunk and Q == 1;
                # window_budget then clamps N to what the pool can host
                # without eviction and pre-allocates the window's pages.
                # W == 1 keeps the single-step path
                fused_w, fused_max, fused_reason = 1, 0, "single_step"
                if plan is not None and plan.n_prefill == 0 \
                        and plan.tok.shape[1] == 1:
                    fused_max = int(get_flag("serving_fused_steps") or 1)
                    if fused_max > 1:
                        fused_w, fused_reason = \
                            self.scheduler.window_budget(plan, fused_max)
            if plan is None:
                # runnable work exists but no pages/slots right now
                time.sleep(0.005)
                continue
            try:
                if fused_w > 1:
                    self._run_window(plan, fused_w, fused_max,
                                     fused_reason)
                else:
                    self._run_step(plan)
            except Exception as e:  # noqa: BLE001 — the failed step
                # fails its own requests, loudly; the engine goes on
                warnings.warn(f"serving step failed: "
                              f"{type(e).__name__}: {e}", stacklevel=1)
                with self._wake:
                    self._failed_steps += 1
                    for seq in plan.seqs:
                        if not seq.req.done:
                            self.scheduler.finish(
                                seq, error=f"serving step failed: "
                                           f"{type(e).__name__}: {e}")
                    self._g_occ.set(len(self.scheduler.running))

    def _note_admissions_locked(self, admitted, evicted) -> None:
        """Close the admitted requests' queue spans and emit their
        ``serving_admit`` / ``evict`` events (a requeued request opens a
        fresh queue span); refresh the gauges."""
        now = time.monotonic()
        for seq in admitted:
            req = seq.req
            qs, req._queue_span = req._queue_span, None
            if qs is not None:
                qs.end(cached_tokens=seq.cached_tokens,
                       resumed=req.evictions > 0)
            tr = req.trace
            _events.emit("serving_admit", request=req.id,
                         prompt_len=len(req.prompt),
                         cached_tokens=seq.cached_tokens,
                         queue_s=round(now - req.submitted_at, 6),
                         resumed=req.evictions > 0,
                         trace_id=tr.trace_id if tr else None,
                         span=tr.span_id if tr else None)
        for seq in evicted:
            self._c_evict.inc()
            req = seq.req
            tr = req.trace
            _events.emit("evict", request=req.id, kv_len=len(seq.tokens),
                         n_generated=seq.n_generated,
                         reason="page_exhaustion",
                         trace_id=tr.trace_id if tr else None,
                         span=tr.span_id if tr else None)
            if tr is not None and req._queue_span is None:
                req._queue_span = _tracing.start_span(
                    "queue", parent=tr, attrs={"resumed": True})
        self._g_queue.set(self.scheduler.queue_depth())
        self._g_occ.set(len(self.scheduler.running))

    def _put(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run_step(self, plan):
        # one SHARED step span for the whole ragged iteration, linked
        # from every member request's trace; the batch_step event below
        # inherits its trace_id/span
        with _tracing.trace_span("batch_step", links=_links(plan),
                                 attrs={"engine": self.engine_id}):
            self._run_step_traced(plan)

    def _run_step_traced(self, plan):
        qw = _bucket(plan.tok.shape[1])
        pad = ((0, 0), (0, qw - plan.tok.shape[1]))
        put = self._put
        launches0 = _rpa.launches
        with self._h_step.time() as step_timer, torch.no_grad():
            logits, _ = self._step_fn(
                self._params, put(np.pad(plan.tok, pad)),
                put(np.pad(plan.pos, pad)), self._pools,
                put(np.pad(plan.page_ids, pad,
                           constant_values=self.pool.sink)),
                put(np.pad(plan.slots, pad)), put(plan.kv_lens),
                put(plan.q_lens), put(plan.tables))
            nxt = serving_sample(logits, put(plan.temps), self._gen)
            # THE device read of the step: admission, eviction and EOS
            # all key off it
            toks = nxt.cpu().numpy()  # noqa: PTL701 — the one read per step
        step_s = step_timer.seconds
        launched = _rpa.launches - launches0
        with self._wake:
            self.scheduler.commit(plan)
            self._steps += 1
            self._c_steps.inc()
            # host clock around dispatch + the read that waits for it
            if plan.n_prefill:
                self._prefill_steps += 1
                self._prefill_step_s += step_s
            else:
                self._decode_step_s += step_s
            self._dispatches += 1
            self._c_dispatch.inc()
            self._host_reads += 1
            self._kernel_launches += launched
            self._prefill_tokens += plan.fed_prefill
            self._c_prefill.inc(plan.fed_prefill)
            now = time.monotonic()
            for i, seq in enumerate(plan.seqs):
                if seq.req.done:
                    continue        # finished (stop()/cancel) mid-step
                if seq.kv_len < len(seq.tokens):
                    continue        # chunked prefill still in flight
                self._emit_tokens_locked(seq, [int(toks[i])], now)
            self._g_occ.set(len(self.scheduler.running))
            self._emit_batch_step_locked(
                plan, plan.n_prefill, int(qw),
                plan.fed_prefill + plan.fed_decode, step_s, 1,
                "single_step")

    def _emit_tokens_locked(self, seq, toks, now) -> bool:
        """Hand one lane's new tokens to its request, in order, and
        finish it at EOS, at its budget or at the NaN sentinel (-1,
        which fails this lane alone: co-batched lanes never mix
        activations).  Returns True when the request finished."""
        req = seq.req
        for tok_i in toks:
            if tok_i < 0:
                self.scheduler.finish(seq, error="NaN logits: request "
                                                 "failed")
                return True
            seq.tokens.append(tok_i)
            req._emit(tok_i)
            self._decode_tokens += 1
            self._c_decode.inc()
            if len(req.tokens) == 1:
                self._h_ttft.observe(now - req.submitted_at)
            eos = req.eos_token_id
            if (eos is not None and tok_i == eos) or \
                    len(req.tokens) >= req.max_new_tokens:
                if self.prefix_cache is not None and \
                        not seq.cache_inserted:
                    self._cache_prompt(seq)
                self.scheduler.finish(seq)
                self._h_latency.observe(now - req.submitted_at)
                return True
        if self.prefix_cache is not None and not seq.cache_inserted:
            self._cache_prompt(seq)
        return False

    def _emit_batch_step_locked(self, plan, prefill_seqs, q_width, tokens,
                                step_s, fused_steps, exit_reason) -> None:
        _events.emit("batch_step", batch=len(plan.seqs),
                     prefill_seqs=prefill_seqs, decode_seqs=plan.n_decode,
                     q_width=q_width, tokens=tokens,
                     queue_depth=self.scheduler.queue_depth(),
                     step_s=round(step_s, 6),
                     page_occupancy=round(
                         1.0 - self.pool.available()
                         / max(self.pool.num_pages - 1, 1), 4),
                     fused_steps=fused_steps, exit_reason=exit_reason)

    def _window(self, max_window: int):
        """The window function of ``build_fused_window_step``, built
        once per ``max_window``; it reads the same parameters as the
        single step."""
        fn = self._windows.get(max_window)
        if fn is None:
            _, fn = self.model.build_fused_window_step(max_window)
            self._windows[max_window] = fn
        return fn

    def _run_window(self, plan, w, max_window, clamp_reason):
        """A fused serving window: ``w`` decode iterations dispatched,
        one packed read (same shared batch_step span as ``_run_step``)."""
        with _tracing.trace_span("batch_step", links=_links(plan),
                                 attrs={"engine": self.engine_id,
                                        "fused": True}):
            self._run_window_traced(plan, w, max_window, clamp_reason)

    def _run_window_traced(self, plan, w, max_window, clamp_reason):
        b = self.max_batch
        put = self._put
        window = self._window(max_window)
        # PRE-append lengths: the committed KV, not the plan's post-step
        # kv_lens — the window owns the append cursor
        kv0 = (plan.kv_lens - plan.q_lens).astype("int32")
        live = plan.q_lens > 0
        tok0 = plan.tok[:, 0].astype("int32")
        eos_ids = np.full((b,), -1, "int32")     # -1 is never sampled
        budgets = np.full((b,), 2 ** 30, "int32")
        for i, seq in enumerate(plan.seqs):
            eos = seq.req.eos_token_id
            eos_ids[i] = -1 if eos is None else int(eos)
            budgets[i] = seq.req.max_new_tokens - len(seq.req.tokens)
        rng_states = []
        launches0 = _rpa.launches
        with self._h_step.time() as step_timer, torch.no_grad():
            packed, _ = window(
                self._params, put(tok0), self._pools, put(kv0), put(live),
                put(plan.tables), put(plan.temps), put(eos_ids),
                put(budgets), self._gen, w, rng_states=rng_states)
            # double-buffered plan: the device is running the window —
            # pre-stage the next boundary's admission NOW (the read
            # below is where the host waits)
            with self._wake:
                self.scheduler.prestage_plan(plan, w)
            # THE boundary read: ONE packed device read per window —
            # tokens, finished mask and iteration count in one array
            out = packed.cpu().numpy()  # noqa: PTL701 — window boundary
        steps = int(out[0, max_window + 1])
        # the generator stands where `steps` single steps leave it
        self._gen.set_state(rng_states[steps])
        step_s = step_timer.seconds
        launched = _rpa.launches - launches0
        with self._wake:
            self.scheduler.commit_window(plan, steps)
            self._steps += steps
            self._c_steps.inc(steps)
            self._window_idle += w - steps
            self._decode_step_s += step_s
            self._dispatches += 1
            self._c_dispatch.inc()
            self._host_reads += 1
            self._kernel_launches += launched
            now = time.monotonic()
            any_finished = False
            for i, seq in enumerate(plan.seqs):
                if seq.req.done:
                    continue        # finished (stop()/cancel) mid-window
                any_finished |= self._emit_tokens_locked(
                    seq, [int(t) for t in out[i, :steps]], now)
            self._g_occ.set(len(self.scheduler.running))
            self._emit_batch_step_locked(
                plan, 0, 1, len(plan.seqs) * steps, step_s, steps,
                "finished" if any_finished else clamp_reason)

    def _cache_prompt(self, seq):
        """Share the finished prompt's full pages through the prefix
        cache (once per admission; pages the sequence itself borrowed
        from the cache are skipped)."""
        self.prefix_cache.insert(seq.req.prompt, seq.pages,
                                 shared=seq.shared)
        seq.cache_inserted = True

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        """Counters: ``steps`` (iterations that ran), ``dispatches`` and
        ``host_reads`` (one per dispatch: a single step or a window),
        ``window_idle_iterations`` (dispatched window iterations after a
        finish, which change nothing), ``kernel_launches`` (K7, the
        ragged attention), step host-clock sums (``decode_step_s``
        covers single decode steps and windows) and the scheduler's."""
        with self._lock:
            out = {"engine": self.engine_id,
                   "device": str(self.device),
                   "health": self.health,
                   "queue_depth": self.scheduler.queue_depth(),
                   "running": len(self.scheduler.running),
                   "steps": self._steps,
                   "dispatches": self._dispatches,
                   "host_reads": self._host_reads,
                   "window_idle_iterations": self._window_idle,
                   "prefill_tokens": self._prefill_tokens,
                   "decode_tokens": self._decode_tokens,
                   "evictions": self.scheduler.evictions,
                   "prefill_steps": self._prefill_steps,
                   "prefill_step_s": self._prefill_step_s,
                   "decode_step_s": self._decode_step_s,
                   "kernel_launches": self._kernel_launches,
                   "failed_steps": self._failed_steps,
                   "cancelled": self._n_cancelled,
                   "prestaged_plans": self.scheduler.prestaged_plans,
                   "prestage_commits": self.scheduler.prestage_commits,
                   "prestage_discards": self.scheduler.prestage_discards,
                   "free_pages": self.pool.available()}
            if self.prefix_cache is not None:
                out["prefix_cache"] = self.prefix_cache.stats()
        return out
