"""Continuous-batching serving engine — joins the scheduler, the ragged
paged attention step and the prefix cache into one token-streaming
service; the port of ``paddle_tpu/serving/engine.py``.

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
steps, bisection probes and ``fused_steps == 1`` keep the single-step
path.

Observability, as in the JAX engine: ``serving_admit`` / ``batch_step``
/ ``evict`` / ``request_cancelled`` / ``quarantine`` /
``health_transition`` / ``step_timeout`` events, queue-depth,
batch-occupancy and health gauges, step / end-to-end /
time-to-first-token histograms and token / step / dispatch /
quarantine / cancel / step-timeout counters, all on the metrics registry
that ``GET /metrics`` exports; ``submit(trace=...)`` parents a request's
root span (``serving_request``) and its queue-wait span, and every step
or window is one ``batch_step`` span linked from its requests' traces.

Fault containment, as in the JAX engine — co-batching couples failure
domains, and four pieces bound the blast radius:

* **poison quarantine** — a failed step is retried by bisection over the
  batch's request ids (nothing commits before the step's read, so
  re-feeding the same chunks is idempotent); innocents complete, the
  isolated offender fails alone with a ``quarantine`` event, and its
  prompt hash is rejected at admission from then on.  A lane whose
  logits hold a NaN samples -1 on the device (``serving_sample``) and is
  quarantined alone at the step's read.  Before bisecting, a small
  device op and a synchronize probe the CUDA context: after a sticky
  error (an illegal address) every launch fails, so the engine goes
  ``failed`` instead of quarantining the innocents one by one;
* **hung-step watchdog** — ``FLAGS_serving_step_timeout_s`` bounds every
  dispatch (the kernels build in ``start()``, and the first dispatch of
  each step shape gets a grace, so neither a build nor a first call
  reads as a hang); on expiry the flight recorder dumps, the loop
  relaunches under a new epoch with fresh device pools and a generator
  at the last committed state, and every survivor is requeued at the
  FRONT.  The abandoned thread, pools and generator stay referenced
  until that thread exits, so the caching allocator cannot hand their
  memory to the new epoch while a wedged launch may still write it.  A
  thread of an earlier epoch checks the epoch after the fault point and
  before its first launch or draw, and again before every commit, so it
  launches, draws and commits nothing.  A genuine device hang blocks the
  stream: the new epoch's first launch queues behind the hung kernel and
  hangs too, until the relaunch cap sends the engine to ``failed`` —
  the reference's contract (its supervisor restarts the replica), with
  no second stream;
* **deadlines + cancellation** — ``deadline_s`` requests are swept every
  iteration and cancelled mid-batch (pages and the slot free at once);
  with a learned perf model, a doomed deadline is rejected up front;
* **health** — ``ok → degraded → quarantining → failed`` rides
  ``health_transition`` events and the ``paddle_serving_engine_health``
  gauge; ``health_recovery_steps`` clean steps take ``degraded`` back to
  ``ok``.

Chaos hooks: ``FLAGS_fault_schedule`` ``serving_step@N=exc|stall|nan``
(``resilience.faults``).  ``nan`` adds a NaN to one lane's logits, on
that step only: a clean step launches nothing extra.

Predicted-cost admission: with a learned model holding a ``batch_step``
head (``tuning.learned``) and ``max_step_cost_s`` (or
``FLAGS_serving_predicted_admission``) > 0, a prefill joins the batch
only while the predicted step cost stays under the budget.
"""
from __future__ import annotations

import contextlib
import hashlib
import itertools
import threading
import time
import warnings
import weakref
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
from ..resilience import faults as _faults
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
    "engine health state machine (0 ok / 1 degraded / 2 quarantining "
    "/ 3 failed) — the fleet router consumes this to drain sick "
    "replicas before their supervisor must restart them",
    labels=("engine",))
_QUARANTINED = _metrics.counter(
    "paddle_serving_engine_quarantined_total",
    "requests quarantined (poison isolation / NaN-logits sentinel)",
    labels=("engine",))
_CANCELLED = _metrics.counter(
    "paddle_serving_engine_cancelled_total",
    "requests cancelled (deadline, client disconnect, consumer "
    "timeout)", labels=("engine",))
_STEP_TIMEOUTS = _metrics.counter(
    "paddle_serving_engine_step_timeouts_total",
    "hung-step watchdog firings (each one dumps the flight recorder "
    "and relaunches the iteration loop)", labels=("engine",))

# the health ladder the gauge exports; "failed" is terminal for the
# engine object (the fleet supervisor restarts the whole replica)
_HEALTH_RANK = {"ok": 0, "degraded": 1, "quarantining": 2, "failed": 3}

# extra watchdog budget for a dispatch of a step shape the model has not
# run yet in this process (first-call library setup and allocator
# growth), so a first call is never mistaken for a hung device.  A stall
# during such a dispatch is still caught — just this much later.
_COLD_DISPATCH_GRACE_S = 120.0

# model -> the (kind, width) step shapes it has dispatched in this
# process; a watchdog relaunch of the same engine is never cold
_WARM: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

_ENGINE_SEQ = itertools.count(1)
_POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# _maybe_poison's answer to a thread whose epoch was superseded
_SUPERSEDED = object()


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

    ``perf_model`` (``"auto"``: load ``FLAGS_tuning_cache_dir``'s model
    when the budget is > 0; an object with ``has``/``predict`` to inject
    one; None: off) and ``max_step_cost_s`` (None: the flag
    ``serving_predicted_admission``) drive predicted-cost admission;
    ``health_recovery_steps`` clean steps take health from ``degraded``
    back to ``ok``; past ``max_watchdog_relaunches`` the engine goes
    ``failed``.  See the module docstring for the fault-containment
    contract, a genuine device hang included.
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
        # kept so a watchdog relaunch can build FRESH page accounting
        self._num_pages, self._page_size = int(num_pages), ps
        self._prefix_caching = bool(prefix_caching)
        # predicted-cost admission: the scheduler admits prefills against
        # the learned model's predicted batch-step cost (the JAX rule:
        # "auto" loads a model only for a positive budget, and only one
        # with a batch_step head is used)
        if max_step_cost_s is None:
            max_step_cost_s = float(
                get_flag("serving_predicted_admission") or 0.0)
        if perf_model == "auto":
            perf_model = None
            if max_step_cost_s > 0:
                from ..tuning import learned as _learned
                perf_model = _learned.load_model()
        if perf_model is not None and not perf_model.has("batch_step"):
            perf_model = None
        self.scheduler = Scheduler(
            self.pool, max_batch, max_pages_per_seq,
            prefix_cache=self.prefix_cache, max_queue=max_queue,
            max_prefill_chunk=max_prefill_chunk, max_seq_len=max_pos,
            perf_model=perf_model, max_step_cost_s=max_step_cost_s)
        self.max_batch = int(max_batch)
        self.default_eos = None if eos_token_id is None \
            else int(eos_token_id)
        self._pool_shape = (nkv, int(num_pages), ps, hd)
        self._pool_dtype = pool_dtype
        self._pools = self._new_pools()
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
        self._c_quarantined = _QUARANTINED.labels(engine=eid)
        self._c_cancelled = _CANCELLED.labels(engine=eid)
        self._c_step_timeout = _STEP_TIMEOUTS.labels(engine=eid)
        self._lock = make_lock("serving.engine._lock")
        self._wake = make_condition("serving.engine._wake", self._lock)
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._accepting = False
        # -- fault containment state (all under self._lock) --
        # the epoch fences the loop thread and its dispatches: a
        # watchdog relaunch bumps it, and a zombie thread that wakes
        # later sees the mismatch, launches nothing and commits nothing
        self._epoch = 0
        self._dispatch_t0: Optional[float] = None
        self._dispatch_plan = None
        self._dispatch_cold = False
        # the generator's state when the in-flight dispatch started (the
        # last committed state): a failed step rewinds to it, and a
        # relaunch starts its fresh generator from it
        self._dispatch_rng: Optional[torch.Tensor] = None
        self._step_timeout_s = 0.0
        self._watchdog: Optional[threading.Thread] = None
        self._relaunches = 0
        self.max_watchdog_relaunches = int(max_watchdog_relaunches)
        self.health = "ok"
        self._clean_steps = 0
        self.health_recovery_steps = int(health_recovery_steps)
        # prompt_hash -> offence count: repeat offenders rejected at
        # admission (the poison travels with the prompt, not the id)
        self._quarantined: dict = {}
        # request id -> (kind, arg): chaos-injected sticky poison pinned
        # to a request so quarantine bisection is deterministic
        self._poison: dict = {}
        # (thread, pools, generator) of each abandoned epoch, kept alive
        # until its thread exits (a wedged launch may still write them)
        self._abandoned: list = []
        # counters (written by the loop thread under self._lock)
        self._steps = 0             # iterations that ran
        self._dispatches = 0
        self._host_reads = 0        # device reads: one per dispatch
        self._window_idle = 0       # window iterations after a finish
        self._prefill_tokens = 0    # prompt tokens whose KV was built
        self._decode_tokens = 0     # tokens generated
        self._kernel_launches = 0
        self._failed_steps = 0      # dispatches that raised (contained)
        self._prefill_steps = 0     # steps that fed any prompt tokens
        self._prefill_step_s = 0.0
        self._decode_step_s = 0.0   # single decode steps and windows
        self._n_quarantined = 0
        self._n_cancelled = 0
        self._wedged_threads = 0

    def _new_pools(self):
        return [(torch.zeros(self._pool_shape, dtype=self._pool_dtype,
                             device=self.device),
                 torch.zeros(self._pool_shape, dtype=self._pool_dtype,
                             device=self.device))
                for _ in range(self.n_layers)]

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ServingEngine":
        """Start the loop thread (and, with ``FLAGS_serving_step_timeout_s
        > 0``, the watchdog).  On a CUDA device the kernels are built
        here first, so no dispatch waits for ``nvcc``."""
        if self.device.type == "cuda":
            from ..ops import _build
            _build.build_all()
        with self._wake:
            if self._running:
                return self
            self._running = True
            self._accepting = True
            timeout_s = float(get_flag("serving_step_timeout_s") or 0.0)
            self._step_timeout_s = timeout_s
            epoch = self._epoch
            self._thread = threading.Thread(
                target=self._loop, args=(epoch,), daemon=True,
                name=f"serving-engine-{self.engine_id}")
            self._thread.start()
            if timeout_s > 0:
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop, args=(timeout_s,),
                    daemon=True, name=f"serving-watchdog-{self.engine_id}")
                self._watchdog.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0,
             join_timeout: float = 5.0) -> dict:
        """Stop accepting requests; with ``drain`` let every admitted or
        queued request finish first (bounded by ``timeout``), else fail
        them at once; whatever is left then fails.  Join the loop thread
        within ``join_timeout``.  Returns ``{"engine", "health",
        "wedged"}``: ``wedged`` is True when the loop thread is still in
        a step after ``join_timeout`` (the flight recorder dumps and
        health goes ``"failed"``)."""
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
            # fail whatever is left (drain timeout, or drain=False)
            leftovers = list(self.scheduler.waiting) \
                + list(self.scheduler.running)
            self.scheduler.waiting.clear()
            for seq in leftovers:
                self.scheduler.finish(seq, error="engine stopped")
            self._g_queue.set(0)
            self._g_occ.set(0)
            self._wake.notify_all()
            t, self._thread = self._thread, None
            wd, self._watchdog = self._watchdog, None
        wedged = False
        if t is not None:
            t.join(timeout=join_timeout)
            if t.is_alive():
                wedged = True
                warnings.warn(f"serving engine {self.engine_id}: loop "
                              f"thread still in a step after "
                              f"{join_timeout}s — a wedged device "
                              f"dispatch is leaking a thread",
                              stacklevel=2)
                _tracing.dump_flight("serving_stop_wedged")
                with self._lock:
                    self._wedged_threads += 1
                    self._set_health("failed",
                                     "loop thread wedged at stop")
        if wd is not None:
            wd.join(timeout=max(float(join_timeout), 1.0))
        with self._lock:
            self._abandoned = [a for a in self._abandoned
                               if a[0].is_alive()]
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
        ``deadline_s`` bounds the request end to end: it is rejected up
        front (``error_kind="deadline"``) when the learned perf model
        predicts it cannot finish in time, and cancelled mid-batch
        (pages freed at once) when the deadline passes while it runs."""
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
            h = self._prompt_hash(req.prompt)
            if h in self._quarantined:
                # repeat offender: this exact prompt already poisoned a
                # batch — reject at admission instead of letting it fail
                # another co-scheduled batch
                req.error_kind = "quarantined"
                _events.emit("quarantine", request=req.id,
                             reason="repeat offender (prompt hash "
                                    "previously quarantined)",
                             prompt_hash=h, action="rejected", batch=0)
                req._finish(error=f"prompt quarantined after "
                                  f"{self._quarantined[h]} prior "
                                  f"failure(s) (hash {h})")
                return req
            self.scheduler.submit(req)
            self._g_queue.set(self.scheduler.queue_depth())
            self._wake.notify()
        return req

    def generate(self, input_ids, **kw):
        """Synchronous convenience: submit + wait."""
        return self.submit(input_ids, **kw).wait()

    # -- the iteration loop ----------------------------------------------
    def _device_ctx(self):
        """The engine's device as the thread's current CUDA device."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _loop(self, epoch: int):
        """One engine epoch of the iteration loop, under ``no_grad`` and
        the engine's device (both thread-local).  The watchdog bumps
        ``self._epoch`` and starts a replacement thread when a dispatch
        hangs; this wrapper also catches a loop-level crash (a planning
        bug, not a step failure — those are contained per step) so the
        engine fails LOUDLY instead of leaving every consumer blocked."""
        try:
            with torch.no_grad(), self._device_ctx():
                self._loop_body(epoch)
        except Exception as e:  # noqa: BLE001 — last resort: a loop
            # thread dying silently would hang every consumer
            warnings.warn(f"serving engine loop died: "
                          f"{type(e).__name__}: {e}", stacklevel=1)
            with self._wake:
                if epoch != self._epoch:
                    return          # a relaunch already superseded us
                self._accepting = False
                self._set_health("failed", f"loop thread died: "
                                           f"{type(e).__name__}")
                self._fail_all_locked(f"engine loop failed: "
                                      f"{type(e).__name__}: {e}")

    def _loop_body(self, epoch: int):
        while True:
            with self._wake:
                if not self._running or epoch != self._epoch:
                    return
                self._sweep_deadlines_locked()
                if not self.scheduler.has_work():
                    self._wake.wait(0.05)
                    continue
                plan, admitted, evicted = self.scheduler.plan_step()
                self._note_admissions_locked(admitted, evicted)
                # fused-window eligibility (the JAX rule): pure
                # steady-state decode only, no prefill chunk and Q == 1,
                # and no bisection episode (probe batches must fail one
                # iteration at a time); window_budget then clamps N to
                # what the pool can host without eviction and
                # pre-allocates the window's pages.  W == 1 keeps the
                # single-step path
                fused_w, fused_max, fused_reason = 1, 0, "single_step"
                if plan is not None and plan.n_prefill == 0 \
                        and plan.tok.shape[1] == 1 \
                        and not self.scheduler.bisect_groups:
                    fused_max = int(get_flag("serving_fused_steps") or 1)
                    if fused_max > 1:
                        fused_w, fused_reason = \
                            self.scheduler.window_budget(plan, fused_max)
            if plan is None:
                # runnable work exists but no pages/slots right now
                time.sleep(0.005)
                continue
            with self._lock:
                if epoch != self._epoch:
                    return
                # watchdog bracket: the dispatch about to start is
                # bounded by FLAGS_serving_step_timeout_s from here
                self._dispatch_t0 = time.monotonic()
                self._dispatch_plan = plan
                self._dispatch_cold = False
                self._dispatch_rng = self._gen.get_state()
            try:
                if fused_w > 1:
                    self._run_window(plan, fused_w, fused_max,
                                     fused_reason, epoch)
                else:
                    self._run_step(plan, epoch)
            except Exception as e:  # noqa: BLE001 — containment, not
                # crash-out: the batch is retried by bisection and only
                # the isolated offender fails
                warnings.warn(f"serving step failed: "
                              f"{type(e).__name__}: {e}", stacklevel=1)
                self._contain_step_failure(plan, e, epoch)
            finally:
                with self._lock:
                    if epoch == self._epoch:
                        self._dispatch_t0 = None
                        self._dispatch_plan = None
                        self._dispatch_rng = None

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
                         predicted_cost_s=(
                             round(seq.predicted_cost_s, 6)
                             if seq.predicted_cost_s is not None
                             else None),
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

    def _mark_warm(self, key) -> bool:
        """Record that the model dispatched step shape ``key``; True the
        first time (a cold dispatch: the watchdog grants it the grace)."""
        with self._lock:
            warm = _WARM.setdefault(self.model, set())
            if key in warm:
                return False
            warm.add(key)
            self._dispatch_cold = True
            return True

    def _maybe_poison(self, plan, epoch: int):
        """Chaos hook (``serving_step@N=exc|nan``) at the top of a
        dispatch, before any launch.  A fired fault pins STICKY poison to
        the first request of the triggering batch, so every retry
        containing it fails deterministically and the quarantine
        bisection converges on it.  Returns the lane to NaN-poison on
        the device, None, or ``_SUPERSEDED`` when a watchdog relaunch
        replaced this thread's epoch while it sat in the fault point."""
        _faults.maybe_fault("serving_step")
        with self._lock:
            if epoch != self._epoch:
                return _SUPERSEDED
            directive = _faults.take_serving_poison()
            if directive is not None and plan.seqs:
                self._poison[plan.seqs[0].req.id] = directive
            lane = None
            for i, seq in enumerate(plan.seqs):
                d = self._poison.get(seq.req.id)
                if d is None:
                    continue
                if d[0] == "exc":
                    raise _faults.InjectedFault(
                        f"injected serving_step poison "
                        f"(request {seq.req.id})")
                lane = i                  # kind "nan": poison on device
        return lane

    def _run_step(self, plan, epoch: int):
        # one SHARED step span for the whole ragged iteration, linked
        # from every member request's trace; the batch_step event below
        # inherits its trace_id/span
        with _tracing.trace_span("batch_step", links=_links(plan),
                                 attrs={"engine": self.engine_id}):
            self._run_step_traced(plan, epoch)

    def _run_step_traced(self, plan, epoch: int):
        # snapshot the device state FIRST: if this thread stalls and the
        # watchdog relaunches around it, a zombie may only ever touch
        # the ABANDONED pools and generator it captured here
        pools_in, gen = self._pools, self._gen  # noqa: PTL902 — THE zombie-containment snapshot: lock-free on purpose
        nan_lane = self._maybe_poison(plan, epoch)
        if nan_lane is _SUPERSEDED:
            return                  # zombie: launch nothing, draw nothing
        qw = _bucket(plan.tok.shape[1])
        cold_start = self._mark_warm(("step", qw))
        pad = ((0, 0), (0, qw - plan.tok.shape[1]))
        sink = pools_in[0][0].shape[1] - 1   # the captured pools' last page
        put = self._put
        launches0 = _rpa.launches
        with self._h_step.time() as step_timer:
            logits, _ = self._step_fn(
                self._params, put(np.pad(plan.tok, pad)),
                put(np.pad(plan.pos, pad)), pools_in,
                put(np.pad(plan.page_ids, pad, constant_values=sink)),
                put(np.pad(plan.slots, pad)), put(plan.kv_lens),
                put(plan.q_lens), put(plan.tables))
            if nan_lane is not None:
                # chaos NaN injection, on this step only: a clean step
                # launches nothing for it
                poison = torch.zeros(logits.shape[0], dtype=logits.dtype,
                                     device=logits.device)
                poison[nan_lane] = float("nan")
                logits = logits + poison[:, None]
            nxt = serving_sample(logits, put(plan.temps), gen)
            # THE device read of the step: admission, eviction and EOS
            # all key off it (a kernel fault surfaces here, inside the
            # loop's contained try)
            toks = nxt.cpu().numpy()  # noqa: PTL701 — the one read per step
        step_s = step_timer.seconds
        launched = _rpa.launches - launches0
        with self._wake:
            if epoch != self._epoch:
                return    # watchdog relaunched mid-dispatch: zombie
                          # result — the fresh epoch re-runs the work
            self.scheduler.commit(plan)
            group = plan.bisect_group
            if group is not None:
                # this probe batch ran clean: its members are proven
                # innocent — retire the group and, once every group
                # resolved, close the quarantine episode
                self.scheduler.bisect_done(group)
                if not self.scheduler.bisect_groups:
                    self._end_quarantine_locked(
                        "bisection episode resolved")
            self._note_clean_step_locked()
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
                self._emit_tokens_locked(seq, [int(toks[i])], now,
                                         len(plan.seqs))
            self._g_occ.set(len(self.scheduler.running))
            self._emit_batch_step_locked(
                plan, plan.n_prefill, int(qw),
                plan.fed_prefill + plan.fed_decode, step_s, cold_start, 1,
                "single_step")

    def _emit_tokens_locked(self, seq, toks, now, batch: int) -> bool:
        """Hand one lane's new tokens to its request, in order, and
        finish it at EOS or at its budget.  The NaN sentinel (-1)
        quarantines this lane alone: co-batched lanes never mix
        activations, so the rest of the batch is sound.  Returns True
        when the request finished."""
        req = seq.req
        for tok_i in toks:
            if tok_i < 0:
                self._quarantine_locked(seq, reason="nan_logits",
                                        batch=batch)
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
                                step_s, cold_start, fused_steps,
                                exit_reason) -> None:
        # step_s + page_occupancy make each record a ready-made
        # (features, seconds) sample for the learned perf model
        # (analysis.perf_features / tuning.learned); cold_start marks a
        # step shape's first dispatch, which the featurizer and the
        # divergence watchdog skip
        _events.emit("batch_step", batch=len(plan.seqs),
                     prefill_seqs=prefill_seqs, decode_seqs=plan.n_decode,
                     q_width=q_width, tokens=tokens,
                     queue_depth=self.scheduler.queue_depth(),
                     step_s=round(step_s, 6),
                     cold_start=cold_start or None,
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

    def _run_window(self, plan, w, max_window, clamp_reason, epoch: int):
        """A fused serving window: ``w`` decode iterations dispatched,
        one packed read (same shared batch_step span as ``_run_step``)."""
        with _tracing.trace_span("batch_step", links=_links(plan),
                                 attrs={"engine": self.engine_id,
                                        "fused": True}):
            self._run_window_traced(plan, w, max_window, clamp_reason,
                                    epoch)

    def _run_window_traced(self, plan, w, max_window, clamp_reason,
                           epoch: int):
        # snapshot the device state FIRST (see _run_step_traced)
        pools_in, gen = self._pools, self._gen  # noqa: PTL902 — zombie-containment snapshot (window path)
        # the window takes no poison vector, so "nan" poison degrades to
        # a pre-dispatch raise here — the failure still quarantines
        # through the same bisection (which pins the single-step path,
        # where the NaN injection takes over)
        with self._lock:
            for seq in plan.seqs:
                if seq.req.id in self._poison:
                    raise _faults.InjectedFault(
                        f"injected serving_step poison "
                        f"(request {seq.req.id})")
        _faults.maybe_fault("serving_step")
        with self._lock:
            if epoch != self._epoch:
                return              # zombie: launch nothing, draw nothing
            directive = _faults.take_serving_poison()
            if directive is not None and plan.seqs:
                self._poison[plan.seqs[0].req.id] = directive
                raise _faults.InjectedFault(
                    f"injected serving_step poison "
                    f"(request {plan.seqs[0].req.id})")
        b = self.max_batch
        put = self._put
        window = self._window(max_window)
        cold_start = self._mark_warm(("window", max_window))
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
        with self._h_step.time() as step_timer:
            packed, _ = window(
                self._params, put(tok0), pools_in, put(kv0), put(live),
                put(plan.tables), put(plan.temps), put(eos_ids),
                put(budgets), gen, w, rng_states=rng_states)
            # double-buffered plan: the device is running the window —
            # pre-stage the next boundary's admission NOW (the read
            # below is where the host waits)
            with self._wake:
                if epoch == self._epoch:
                    self.scheduler.prestage_plan(plan, w)
            # THE boundary read: ONE packed device read per window —
            # tokens, finished mask and iteration count in one array
            out = packed.cpu().numpy()  # noqa: PTL701 — window boundary
        steps = int(out[0, max_window + 1])
        step_s = step_timer.seconds
        launched = _rpa.launches - launches0
        with self._wake:
            if epoch != self._epoch:
                return    # zombie window result after a relaunch
            # the generator stands where `steps` single steps leave it
            gen.set_state(rng_states[steps])
            self._note_clean_step_locked(steps)
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
                    seq, [int(t) for t in out[i, :steps]], now,
                    len(plan.seqs))
            self._g_occ.set(len(self.scheduler.running))
            self._emit_batch_step_locked(
                plan, 0, 1, len(plan.seqs) * steps, step_s, cold_start,
                steps, "finished" if any_finished else clamp_reason)

    def _cache_prompt(self, seq):
        """Share the finished prompt's full pages through the prefix
        cache (once per admission; pages the sequence itself borrowed
        from the cache are skipped)."""
        self.prefix_cache.insert(seq.req.prompt, seq.pages,
                                 shared=seq.shared)
        seq.cache_inserted = True

    # -- fault containment: quarantine bisection -------------------------
    @staticmethod
    def _prompt_hash(prompt) -> str:
        return hashlib.sha256(
            ",".join(map(str, prompt)).encode()).hexdigest()[:16]

    def _device_ok(self) -> bool:
        """After a failed step: does the device still run work?  A
        sticky CUDA error (an illegal address) fails every later launch
        in the process, so bisection would "isolate" each innocent in
        turn.  A small op and a synchronize tell the two apart."""
        if self.device.type != "cuda":
            return True
        try:
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)
        except RuntimeError:        # the probe's answer: it cannot
            return False
        return True

    def _contain_step_failure(self, plan, exc, epoch: int) -> None:
        """A dispatch raised.  Nothing was committed (tokens only land
        after the step's read), so re-feeding the same chunks to the
        same pages is idempotent — instead of failing the whole batch,
        split its live members in half and probe each half as its own
        restricted plan until the offender is alone.  The generator
        rewinds to the dispatch's start, as the JAX engine's functional
        key does.  A device that no longer runs work fails the engine
        instead (nothing is quarantined)."""
        device_ok = self._device_ok()
        with self._wake:
            if epoch != self._epoch:
                return              # a relaunch already superseded us
            self._failed_steps += 1
            self._clean_steps = 0
            if self._dispatch_rng is not None:
                self._gen.set_state(self._dispatch_rng)
            if not device_ok:
                self._accepting = False
                self._set_health(
                    "failed", f"device error after a failed step "
                              f"({type(exc).__name__})")
                self._fail_all_locked(
                    f"engine failed: the device no longer runs work "
                    f"({type(exc).__name__}: {exc})")
                self._wake.notify_all()
                return
            group = plan.bisect_group
            if group is not None:
                self.scheduler.bisect_done(group)
            live = [s for s in plan.seqs
                    if s in self.scheduler.running and not s.req.done]
            if len(live) <= 1:
                # isolated (or the batch emptied mid-flight): the
                # offender fails ALONE; everyone else was or will be
                # proven innocent by their own clean probe
                for seq in live:
                    self._quarantine_locked(
                        seq,
                        reason=f"step failure: "
                               f"{type(exc).__name__}: {exc}",
                        batch=len(plan.seqs))
                if not self.scheduler.bisect_groups:
                    self._end_quarantine_locked("offender isolated")
                return
            if self.health in ("ok", "degraded"):
                self._set_health(
                    "quarantining",
                    f"step failed over {len(live)} requests "
                    f"({type(exc).__name__}) — bisecting")
            ids = [s.req.id for s in live]
            mid = len(ids) // 2
            self.scheduler.bisect_push_front([ids[:mid], ids[mid:]])

    def _quarantine_locked(self, seq, reason: str, batch: int) -> None:
        req = seq.req
        h = self._prompt_hash(req.prompt)
        self._quarantined[h] = self._quarantined.get(h, 0) + 1
        self._poison.pop(req.id, None)
        self._n_quarantined += 1
        self._c_quarantined.inc()
        _events.emit("quarantine", request=req.id, reason=reason,
                     prompt_hash=h, action="quarantined", batch=batch)
        req.error_kind = "quarantined"
        self.scheduler.finish(seq, error=f"request quarantined: {reason}")
        self._g_occ.set(len(self.scheduler.running))

    # -- fault containment: health state machine -------------------------
    def _set_health(self, state: str, reason: str) -> None:
        prev = self.health
        if state == prev:
            return
        self.health = state
        self._clean_steps = 0
        self._g_health.set(_HEALTH_RANK[state])
        _events.emit("health_transition", engine=self.engine_id,
                     previous=prev, state=state, reason=reason)

    def _end_quarantine_locked(self, reason: str) -> None:
        if self.health == "quarantining":
            self._set_health("degraded", reason)

    def _note_clean_step_locked(self, n: int = 1) -> None:
        self._clean_steps += int(n)
        if self.health == "degraded" \
                and self._clean_steps >= self.health_recovery_steps:
            self._set_health("ok", f"{self._clean_steps} clean steps")

    def _fail_all_locked(self, error: str) -> None:
        leftovers = list(self.scheduler.waiting) \
            + list(self.scheduler.running)
        self.scheduler.waiting.clear()
        for seq in leftovers:
            seq.req.error_kind = seq.req.error_kind or "unhealthy"
            self.scheduler.finish(seq, error=error)
        self._g_queue.set(0)
        self._g_occ.set(0)

    # -- fault containment: hung-step watchdog ---------------------------
    def _watchdog_loop(self, timeout: float) -> None:
        poll = max(min(timeout / 4.0, 0.25), 0.01)
        while True:
            with self._lock:
                if not self._running:
                    return
                t0 = self._dispatch_t0
                budget = timeout + (_COLD_DISPATCH_GRACE_S
                                    if self._dispatch_cold else 0.0)
            if t0 is not None and time.monotonic() - t0 > budget:
                self._recover_from_stall(timeout)
            time.sleep(poll)

    def _recover_from_stall(self, timeout: float) -> None:
        """A dispatch exceeded the watchdog budget: dump the flight
        recorder, abandon the wedged epoch (thread, device pools,
        generator, page accounting) and relaunch with every survivor
        requeued at the FRONT — the eviction-resume contract replays
        their prompt+generated tokens, so no stream truncates."""
        with self._wake:
            t0 = self._dispatch_t0
            budget = timeout + (_COLD_DISPATCH_GRACE_S
                                if self._dispatch_cold else 0.0)
            if t0 is None or time.monotonic() - t0 <= budget:
                return          # resolved while we were scheduled
            age = time.monotonic() - t0
            plan = self._dispatch_plan
            self._relaunches += 1
            self._clean_steps = 0
            self._c_step_timeout.inc()
            _events.emit(
                "step_timeout", engine=self.engine_id,
                age_s=round(age, 3), timeout_s=float(timeout),
                batch=len(plan.seqs) if plan is not None else 0,
                relaunches=self._relaunches)
            _tracing.dump_flight("serving_step_timeout")
            if self._relaunches > self.max_watchdog_relaunches:
                # a dispatch that hangs this persistently is not coming
                # back: stop relaunching, fail LOUDLY and let the fleet
                # supervisor restart the whole replica
                self._epoch += 1
                self._dispatch_t0 = None
                self._dispatch_plan = None
                self._accepting = False
                self._set_health(
                    "failed",
                    f"{self._relaunches} watchdog relaunches exceed "
                    f"the cap ({self.max_watchdog_relaunches})")
                self._fail_all_locked(
                    "engine failed: repeated hung steps")
                self._wake.notify_all()
                return
            self._set_health(
                "degraded",
                f"hung step ({age:.1f}s > {timeout}s) — relaunching "
                f"the iteration loop")
            self._relaunch_locked()

    def _relaunch_locked(self) -> None:
        self._epoch += 1
        epoch = self._epoch
        rng = self._dispatch_rng
        self._dispatch_t0 = None
        self._dispatch_plan = None
        self._dispatch_rng = None
        # requeue EVERY running sequence at the front, generated tokens
        # kept: re-admission re-prefills prompt+generated and continues
        # token-exact (greedy), exactly like an eviction
        for seq in reversed(list(self.scheduler.running)):
            seq.pages = []      # the pool they point into is dead
            seq.shared = set()
            seq.kv_len = 0
            seq.cached_tokens = 0
            seq.cache_inserted = False
            seq.req.evictions += 1
            self.scheduler.evictions += 1
            self.scheduler.waiting.appendleft(seq)
        self.scheduler.running.clear()
        # the wedged dispatch may still write the old pools: they stay
        # referenced (with the thread and its generator) until that
        # thread exits, and the new epoch gets fresh page accounting,
        # fresh pools and a generator at the last committed state
        self._abandoned = [a for a in self._abandoned if a[0].is_alive()]
        self._abandoned.append((self._thread, self._pools, self._gen))
        self.pool = PagePool(self._num_pages, self._page_size)
        self.prefix_cache = PrefixCache(self.pool) \
            if self._prefix_caching else None
        self.scheduler.rebind_pool(self.pool, self.prefix_cache)
        self._pools = self._new_pools()
        gen = torch.Generator(device=self.device)
        gen.set_state(rng if rng is not None else self._gen.get_state())
        self._gen = gen
        self._thread = threading.Thread(
            target=self._loop, args=(epoch,), daemon=True,
            name=f"serving-engine-{self.engine_id}-e{epoch}")
        self._thread.start()
        self._wake.notify_all()

    # -- fault containment: deadlines + cancellation ---------------------
    def _cancel_request(self, req, reason: str) -> None:
        """``Request.cancel()`` hook: routes through the engine lock so
        pages and the batch slot free immediately."""
        with self._wake:
            self._cancel_locked(req, reason)

    def _cancel_locked(self, req, reason: str) -> None:
        if req.done:
            return
        req.error_kind = req.error_kind or "cancelled"
        self._n_cancelled += 1
        self._c_cancelled.inc()
        _events.emit("request_cancelled", request=req.id,
                     reason=reason, n_tokens=len(req.tokens),
                     deadline_s=req.deadline_s)
        self.scheduler.drop(req, error=reason)
        self._g_queue.set(self.scheduler.queue_depth())
        self._g_occ.set(len(self.scheduler.running))

    def _sweep_deadlines_locked(self) -> None:
        now = time.monotonic()
        expired = [s.req for s in (list(self.scheduler.running)
                                   + list(self.scheduler.waiting))
                   if s.req.deadline_at is not None
                   and now > s.req.deadline_at]
        for req in expired:
            req.error_kind = "deadline"
            self._cancel_locked(
                req, f"deadline exceeded ({req.deadline_s}s)")

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        """Counters: ``steps`` (iterations that ran), ``dispatches`` and
        ``host_reads`` (one per dispatch: a single step or a window),
        ``window_idle_iterations`` (dispatched window iterations after a
        finish, which change nothing), ``kernel_launches`` (K7, the
        ragged attention), ``failed_steps`` (dispatches that raised and
        were contained), step host-clock sums (``decode_step_s`` covers
        single decode steps and windows), the scheduler's, and the
        reference's fault-containment keys: ``health``,
        ``quarantined``, ``quarantined_prompts``, ``cancelled``,
        ``watchdog_relaunches`` and ``wedged_threads``."""
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
                   "deferred_admissions":
                       self.scheduler.deferred_admissions,
                   "prefill_steps": self._prefill_steps,
                   "prefill_step_s": self._prefill_step_s,
                   "decode_step_s": self._decode_step_s,
                   "kernel_launches": self._kernel_launches,
                   "failed_steps": self._failed_steps,
                   "quarantined": self._n_quarantined,
                   "quarantined_prompts": len(self._quarantined),
                   "cancelled": self._n_cancelled,
                   "watchdog_relaunches": self._relaunches,
                   "wedged_threads": self._wedged_threads,
                   "prestaged_plans": self.scheduler.prestaged_plans,
                   "prestage_commits": self.scheduler.prestage_commits,
                   "prestage_discards": self.scheduler.prestage_discards,
                   "free_pages": self.pool.available()}
            if self.prefix_cache is not None:
                out["prefix_cache"] = self.prefix_cache.stats()
        return out
