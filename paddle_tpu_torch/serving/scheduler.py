"""Continuous-batching scheduler — iteration-level request admission
over a refcounted KV page pool (Orca-style); a copy of
``paddle_tpu/serving/scheduler.py`` (numpy and stdlib only): fused-window
budgets and plan pre-staging, deadlines (up-front rejection of a doomed
request), predicted-cost admission against a learned perf model, and the
quarantine-bisection queue the engine's fault containment drives.

This scheduler re-plans every token iteration:

* a new request joins the running batch the moment a slot and enough
  pages exist — its prompt prefills in the same ragged step other
  requests decode in;
* a finished request (EOS or budget) frees its pages IMMEDIATELY, so
  the next iteration can admit;
* page exhaustion evicts the youngest running request (fewest sunk
  tokens) and requeues it at the FRONT of the wait queue — its
  generated-so-far tokens are kept, so re-admission re-prefills
  prompt+generated and continues where it stopped;
* prompt prefixes already resident (``prefix_cache``) are shared by
  refcount instead of recomputed.

Everything here is HOST bookkeeping over python ints (free lists, page
tables, token lists).  The step arrays ride in the :class:`StepPlan`;
the engine owns the device step and its one per-iteration device read.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PagePool", "Request", "Scheduler", "StepPlan"]


class PagePool:
    """Refcounted fixed-size-page allocator (host bookkeeping only —
    the device-resident pools live in the engine).

    The LAST page id is the **sink**: padding slots of a ragged step
    scatter their garbage there; it is never allocated and never
    appears in a page table."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (1 is the sink)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.sink = self.num_pages - 1
        self._free: List[int] = list(range(self.num_pages - 1))[::-1]
        self._refs: Dict[int, int] = {}

    def available(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self) -> int:
        """Allocate one page at refcount 1; raises on exhaustion (the
        scheduler checks ``available()`` and evicts first)."""
        if not self._free:
            raise RuntimeError("KV page pool exhausted")
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def ref(self, page: int) -> None:
        if page not in self._refs:
            raise ValueError(f"page {page} is not live")
        self._refs[page] += 1

    def unref(self, page: int) -> None:
        n = self._refs.get(page)
        if not n:
            raise ValueError(f"page {page} is not live")
        if n == 1:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = n - 1


class Request:
    """One generation request: prompt in, token stream out.

    The engine pushes generated token ids into a per-request queue as
    each batch iteration completes; ``stream()`` yields them live and
    ``wait()`` blocks for the full result.  ``tokens`` accumulates the
    generated ids (prompt excluded)."""

    _IDS = itertools.count(1)

    def __init__(self, input_ids: Sequence[int], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0,
                 request_id: Optional[str] = None,
                 deadline_s: Optional[float] = None):
        self.id = request_id if request_id is not None \
            else str(next(Request._IDS))
        self.prompt: List[int] = [int(t) for t in np.asarray(
            input_ids).reshape(-1)]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = None if eos_token_id is None \
            else int(eos_token_id)
        self.temperature = float(temperature)
        self.tokens: List[int] = []        # generated ids, in order
        self.error: Optional[str] = None
        # machine-readable failure class for the HTTP layer's status
        # mapping: "deadline"/"unhealthy" -> 503, "quarantined" -> 400,
        # "cancelled" stays in-band; None for ordinary errors
        self.error_kind: Optional[str] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self.submitted_at = time.monotonic()
        self.deadline_s = None if deadline_s is None \
            else float(deadline_s)
        self.deadline_at = None if deadline_s is None \
            else self.submitted_at + float(deadline_s)
        # engine-installed cancel hook: routes cancel() through the
        # engine lock so pages and the batch slot free immediately
        self._cancel_cb = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.evictions = 0
        # request-trace handles (observability.tracing), set by the
        # engine at submit: the root request span ties every annotation
        # together; the queue span is open whenever the request waits
        # for admission (incl. after an eviction)
        self.trace = None              # TraceContext of the root span
        self._root_span = None
        self._queue_span = None

    # -- consumer side ---------------------------------------------------
    def stream(self, timeout: Optional[float] = 60.0):
        """Yield generated token ids as they land; returns on EOS /
        budget / failure (raises RuntimeError on failure).  A
        ``timeout`` expiry CANCELS the request before raising: the
        consumer is gone, so the engine frees its pages now."""
        while True:
            try:
                tok = self._queue.get(timeout=timeout)
            except queue.Empty:
                self.cancel(f"stream consumer timed out after "
                            f"{timeout}s without a token")
                raise RuntimeError(
                    self.error or f"request {self.id}: stream timed "
                                  f"out after {timeout}s") from None
            if tok is None:
                if self.error:
                    raise RuntimeError(self.error)
                return
            yield tok

    def wait(self, timeout: Optional[float] = 60.0) -> List[int]:
        """Block until the request finishes; returns the generated ids.
        A timeout cancels the request (see :meth:`stream`) before
        raising TimeoutError."""
        if not self._done.wait(timeout):
            self.cancel(f"wait consumer timed out after {timeout}s")
            raise TimeoutError(f"request {self.id} still running after "
                               f"{timeout}s (request cancelled)")
        if self.error:
            raise RuntimeError(self.error)
        return list(self.tokens)

    def cancel(self, reason: str = "cancelled") -> None:
        """Cancel a queued/running request: pages and the batch slot
        free immediately (via the engine's cancel hook when admitted),
        consumers see the error.  Idempotent after finish."""
        if self._done.is_set():
            return
        cb = self._cancel_cb
        if cb is not None:
            cb(self, reason)
        else:
            self.error_kind = self.error_kind or "cancelled"
            self._finish(error=reason)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    # -- engine side -----------------------------------------------------
    def _emit(self, tok: int) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.tokens.append(int(tok))
        self._queue.put(int(tok))

    def _finish(self, error: Optional[str] = None) -> None:
        # idempotent: stop() and an in-flight step can both try to
        # finish the same request; only the first one wins (a second
        # call would push a spurious None past the stream sentinel)
        if self._done.is_set():
            return
        self.error = error
        self.finished_at = time.monotonic()
        # close the trace: a queue span still open here means the
        # request died waiting (rejected / engine stopped)
        qs, self._queue_span = self._queue_span, None
        if qs is not None:
            qs.end(status="error" if error else "cancelled")
        rs, self._root_span = self._root_span, None
        if rs is not None:
            rs.end(status="error" if error else "ok", error=error,
                   n_tokens=len(self.tokens), evictions=self.evictions)
        self._done.set()
        self._queue.put(None)


class _Sequence:
    """Host decode state of one ADMITTED request: the full known token
    list (prompt + generated so far), how many of them have KV
    committed to pages, and the owned/shared page list."""

    __slots__ = ("req", "tokens", "kv_len", "pages", "shared",
                 "cached_tokens", "cache_inserted", "predicted_cost_s")

    def __init__(self, req: Request):
        self.req = req
        self.tokens: List[int] = list(req.prompt) + list(req.tokens)
        self.kv_len = 0
        self.pages: List[int] = []
        self.shared: set = set()       # page ids held via prefix cache
        self.cached_tokens = 0
        self.cache_inserted = False
        # learned-model step-cost estimate at admission (None: raw
        # page/token caps decided alone); rides serving_admit events
        self.predicted_cost_s: Optional[float] = None

    @property
    def n_generated(self) -> int:
        return len(self.req.tokens)


class StepPlan:
    """One ragged iteration, planned: the active sequences and the
    padded host arrays the engine feeds the device step."""

    __slots__ = ("seqs", "tok", "pos", "page_ids", "slots",
                 "kv_lens", "q_lens", "tables", "temps",
                 "n_prefill", "n_decode", "fed_prefill", "fed_decode",
                 "bisect_group")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _Prestage:
    """The double-buffered plan half-step: admission work computed
    WHILE the device runs a fused window, against the projected
    post-window state (every live lane + ``window`` decode tokens, no
    finishes, no page churn).  ``matches`` decides at the next
    boundary whether the projection held — a finish, an eviction or a
    queue-head change invalidates it and the staged work is
    discarded."""

    __slots__ = ("running_ids", "head_id", "free_pages", "prediction")

    def __init__(self, running_ids, head_id, free_pages, prediction):
        self.running_ids = running_ids
        self.head_id = head_id
        self.free_pages = free_pages
        self.prediction = prediction   # (req_id, predicted_cost_s)

    def matches(self, sched: "Scheduler") -> bool:
        if tuple(s.req.id for s in sched.running) != self.running_ids:
            return False
        if not sched.waiting or sched.waiting[0].req.id != self.head_id:
            return False
        return sched.pool.available() == self.free_pages


class Scheduler:
    """Plans one ragged step per call; owns admission, page
    accounting, eviction and completion.  Thread-compatible: the
    engine serializes calls under its own lock."""

    def __init__(self, pool: PagePool, max_batch: int,
                 max_pages_per_seq: int, prefix_cache=None,
                 max_queue: int = 1024, max_prefill_chunk: int = 0,
                 max_seq_len: int = 0, perf_model=None,
                 max_step_cost_s: float = 0.0):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.ppseq = int(max_pages_per_seq)
        self.prefix_cache = prefix_cache
        self.max_queue = int(max_queue)
        # page capacity rounds UP to whole pages; the model's position
        # tables do not — admission must respect the tighter of the two
        self.max_seq_len = int(max_seq_len)
        # 0: prefill a whole remaining prompt in one step; >0 caps the
        # per-iteration chunk (bounds Q and the step's latency impact
        # on co-scheduled decodes)
        self.max_prefill_chunk = int(max_prefill_chunk)
        # predicted-cost admission (tuning.learned): with a trained
        # batch_step head and a budget, new prefills are admitted only
        # while the PREDICTED next-step cost stays under the budget —
        # the cap follows what a prefill actually costs co-scheduled
        # decodes, not a raw page/token count
        self.perf_model = perf_model
        self.max_step_cost_s = float(max_step_cost_s or 0.0)
        self.deferred_admissions = 0
        self.waiting: deque = deque()
        self.running: List[_Sequence] = []
        self.evictions = 0
        # quarantine bisection (engine fault containment): while
        # non-empty, plan_step restricts each plan to the front
        # group's members (by request id) and pauses admission — the
        # engine splits a failed group in half and pushes both halves
        # here until the offender is isolated
        self.bisect_groups: deque = deque()
        # double-buffered plan (fused serving windows): admission
        # decisions pre-staged against the projected post-window state
        # while the device runs, committed or discarded at the boundary
        self._prestage: Optional[_Prestage] = None
        self._staged_pred = None
        self.prestaged_plans = 0
        self.prestage_commits = 0
        self.prestage_discards = 0

    # -- queue side ------------------------------------------------------
    def submit(self, req: Request) -> None:
        cap = self.ppseq * self.pool.page_size
        if self.max_seq_len:
            cap = min(cap, self.max_seq_len)
        if len(req.prompt) + req.max_new_tokens > cap:
            req._finish(error=f"request needs {len(req.prompt)} + "
                              f"{req.max_new_tokens} tokens; a sequence "
                              f"holds at most {cap}")
            return
        if len(self.waiting) >= self.max_queue:
            req._finish(error="queue full")
            return
        seq = _Sequence(req)
        if req.deadline_at is not None and self.perf_model is not None:
            # predicted-cost admission consults the remaining deadline:
            # a request whose full decode cannot fit inside it is doomed
            # — reject up front (HTTP maps error_kind="deadline" to
            # 503) instead of burning batch slots on a stream that must
            # be cancelled mid-flight.  The per-step prediction is a
            # conservative per-token estimate (it prices the admission
            # step, prefill included).
            pred = self._predicted_admit_cost(seq)
            if pred is not None:
                need_s = pred * max(req.max_new_tokens, 1)
                remaining = req.deadline_at - time.monotonic()
                if need_s > remaining:
                    req.error_kind = "deadline"
                    req._finish(
                        error=f"deadline infeasible: predicted "
                              f"{need_s:.3f}s of decode exceeds the "
                              f"{remaining:.3f}s remaining before the "
                              f"deadline")
                    return
        self.waiting.append(seq)

    def queue_depth(self) -> int:
        return len(self.waiting)

    def has_work(self) -> bool:
        return bool(self.running or self.waiting)

    # -- page accounting -------------------------------------------------
    def _pages_needed(self, seq: _Sequence, new_len: int) -> int:
        ps = self.pool.page_size
        return max(0, -(-new_len // ps) - len(seq.pages))

    def _grow(self, seq: _Sequence, new_len: int) -> bool:
        """Allocate the pages ``seq`` needs to hold ``new_len`` tokens;
        False when the pool cannot satisfy it right now."""
        need = self._pages_needed(seq, new_len)
        if need == 0:
            return True
        if self.pool.available() < need and self.prefix_cache is not None:
            # reclaim cache-only pages (refcount 1, held by the cache
            # alone) before declaring exhaustion
            self.prefix_cache.reclaim(need - self.pool.available())
        if self.pool.available() < need:
            return False
        for _ in range(need):
            seq.pages.append(self.pool.alloc())
        return True

    def _release(self, seq: _Sequence) -> None:
        for page in seq.pages:
            self.pool.unref(page)
        seq.pages = []
        seq.shared = set()
        seq.kv_len = 0

    # -- predicted-cost admission ----------------------------------------
    def _chunk_len(self, seq: _Sequence) -> int:
        n = max(len(seq.req.prompt) + len(seq.req.tokens) - seq.kv_len,
                0)
        if self.max_prefill_chunk:
            n = min(n, self.max_prefill_chunk)
        return n

    def _predicted_admit_cost(self, seq: _Sequence,
                              projected_decode: bool = False
                              ) -> Optional[float]:
        """The learned model's batch-step seconds for the NEXT
        iteration with ``seq`` admitted on top of the running batch
        (the same feature vector ``batch_step`` events log).  None when
        the model can't answer — admission then falls back to the raw
        caps; a model error must never wedge the queue.

        ``projected_decode`` evaluates the POST-window projection the
        fused path pre-stages against: every running lane a one-token
        decode (the state a full fused window leaves behind)."""
        chunk = self._chunk_len(seq)
        if projected_decode:
            chunks = [1 for _ in self.running]
            decode = len(self.running)
        else:
            chunks = [self._chunk_len(s) for s in self.running]
            decode = sum(1 for s in self.running
                         if s.kv_len >= len(s.req.prompt))
        feats = {
            "batch": float(len(self.running) + 1),
            "prefill_seqs": float(len(self.running) - decode + 1),
            "decode_seqs": float(decode),
            "q_width": float(max(chunks + [chunk, 1])),
            "tokens": float(sum(chunks) + chunk),
            "queue_depth": float(len(self.waiting)),
            "page_occupancy": round(
                1.0 - self.pool.available()
                / max(self.pool.num_pages - 1, 1), 4),
            # the step being priced is a single-step admission boundary
            "fused_steps": 1.0,
        }
        try:
            return self.perf_model.predict("batch_step", feats)
        except Exception:  # noqa: PTL401 — a perf-model failure must
            # never wedge admission; None falls back to the raw caps
            return None

    # -- admission / eviction --------------------------------------------
    def _admit_one(self) -> Optional[_Sequence]:
        if not self.waiting or len(self.running) >= self.max_batch:
            return None
        seq = self.waiting[0]
        if self.perf_model is not None and self.max_step_cost_s > 0:
            staged = self._staged_pred
            if staged is not None and staged[0] == seq.req.id:
                # double-buffered plan: the prediction was computed
                # while the device ran the last fused window
                pred = staged[1]
                self._staged_pred = None
            else:
                pred = self._predicted_admit_cost(seq)
            seq.predicted_cost_s = pred
            if pred is not None and pred > self.max_step_cost_s \
                    and self.running:
                # admitting this prefill would blow the step budget —
                # defer until the running batch shrinks.  An empty
                # batch always admits (the budget shapes latency, it
                # must never starve the queue)
                self.deferred_admissions += 1
                return None
        # refresh: an evicted requeued sequence re-enters with its
        # generated-so-far tokens included
        seq.tokens = list(seq.req.prompt) + list(seq.req.tokens)
        cached_pages: List[int] = []
        if self.prefix_cache is not None:
            cached_pages = self.prefix_cache.match(seq.req.prompt)
        ps = self.pool.page_size
        # always feed >= 1 token so the step produces logits; the
        # boundary token's rewrite into a shared page is value-
        # identical (same weights, same tokens, same positions)
        cached_len = min(len(cached_pages) * ps, len(seq.tokens) - 1)
        use_pages = cached_pages[:-(-cached_len // ps) if cached_len
                                 else 0]
        # NO free-list pre-check here: the pool may be held entirely by
        # cache-only prompt pages, and only ``_grow`` reclaims those.
        # Ref the matched pages FIRST so reclaim cannot free them out
        # from under us, then let _grow reclaim/allocate the rest; on
        # failure the shared refs roll back and the request stays at
        # the head of the queue.
        for page in use_pages:
            self.pool.ref(page)
            seq.pages.append(page)
            seq.shared.add(page)
        seq.kv_len = cached_len
        seq.cached_tokens = cached_len
        if not self._grow(seq, len(seq.tokens)):
            # pool short even after reclaiming cache-only pages
            self._release(seq)
            return None
        self.waiting.popleft()
        self.running.append(seq)
        return seq

    def _evict_victim(self, protect) -> Optional[_Sequence]:
        """Preempt the youngest running sequence (most recently
        admitted, none of ``protect``): free its pages, requeue it at
        the FRONT so it resumes as soon as pressure clears.  Sequences
        already laid into the current plan are protected — their pages
        are about to be written and must not be reallocated."""
        for seq in reversed(self.running):
            if seq in protect:
                continue
            self.running.remove(seq)
            self._release(seq)
            seq.req.evictions += 1
            self.evictions += 1
            self.waiting.appendleft(seq)
            return seq
        return None

    # -- completion (engine calls after each step) -----------------------
    def finish(self, seq: _Sequence, error: Optional[str] = None) -> None:
        """EOS / budget / failure: free the pages NOW — the next
        iteration's admission sees them."""
        if seq in self.running:
            self.running.remove(seq)
        self._release(seq)
        seq.req._finish(error=error)

    def drop(self, req: Request, error: str) -> bool:
        """Cancellation path: remove ``req`` wherever it sits (wait
        queue or running batch), free its pages NOW, and finish it with
        ``error``.  Returns True when it was still scheduled."""
        for seq in list(self.waiting):
            if seq.req is req:
                self.waiting.remove(seq)
                seq.req._finish(error=error)
                return True
        for seq in list(self.running):
            if seq.req is req:
                self.running.remove(seq)
                self._release(seq)
                seq.req._finish(error=error)
                return True
        req._finish(error=error)
        return False

    def rebind_pool(self, pool: PagePool, prefix_cache=None) -> None:
        """Watchdog relaunch: the abandoned dispatch may still write
        into the old device buffers, so the engine replaces them AND
        the host page accounting wholesale — rebind to the fresh pool,
        drop staged plans and any in-flight bisection episode."""
        self.pool = pool
        self.prefix_cache = prefix_cache
        self._prestage = None
        self._staged_pred = None
        self.bisect_groups.clear()

    # -- quarantine bisection (engine fault containment) -----------------
    def bisect_push_front(self, groups) -> None:
        """Push request-id groups at the FRONT of the bisection queue
        (the engine splits a failed batch in half and narrows first)."""
        for g in reversed(list(groups)):
            self.bisect_groups.appendleft(frozenset(g))

    def bisect_done(self, group) -> None:
        """A restricted plan for ``group`` resolved (ran clean, or was
        contained) — retire it."""
        if self.bisect_groups and self.bisect_groups[0] == group:
            self.bisect_groups.popleft()

    # -- the per-iteration plan ------------------------------------------
    def plan_step(self):
        """Admit what fits, grow pages for this iteration's tokens
        (evicting under pressure), and lay out the padded step arrays.
        Returns (plan, admitted, evicted) — plan is None when nothing
        is runnable."""
        pre, self._prestage = self._prestage, None
        self._staged_pred = None
        if pre is not None:
            if pre.matches(self):
                self.prestage_commits += 1
                self._staged_pred = pre.prediction
            else:
                self.prestage_discards += 1
        # quarantine bisection: restrict the plan to the front group's
        # members and pause admission until the episode resolves
        group = None
        while self.bisect_groups:
            g = self.bisect_groups[0]
            if any(s.req.id in g for s in self.running):
                group = g
                break
            self.bisect_groups.popleft()   # members finished meanwhile
        admitted: List[_Sequence] = []
        evicted: List[_Sequence] = []
        if group is None:
            while True:
                seq = self._admit_one()
                if seq is None:
                    break
                admitted.append(seq)

        # per-sequence chunk of NEW tokens this iteration
        active: List[Tuple[_Sequence, List[int]]] = []
        for seq in list(self.running):
            if seq not in self.running:
                continue       # evicted by an earlier seq's growth
            if group is not None and seq.req.id not in group:
                continue       # parked while the bisection probes
            chunk = seq.tokens[seq.kv_len:]
            if self.max_prefill_chunk and \
                    len(chunk) > self.max_prefill_chunk:
                chunk = chunk[:self.max_prefill_chunk]
            if not chunk:
                continue
            while not self._grow(seq, seq.kv_len + len(chunk)):
                victim = self._evict_victim(
                    {seq} | {s for s, _ in active})
                if victim is None:
                    break
                evicted.append(victim)
                if victim in admitted:
                    admitted.remove(victim)
            if self._pages_needed(seq, seq.kv_len + len(chunk)) > 0:
                # could not grow even after evicting everything else;
                # park this sequence too and try again next iteration
                if seq in self.running:
                    self.running.remove(seq)
                    self._release(seq)
                    seq.req.evictions += 1
                    self.evictions += 1
                    self.waiting.appendleft(seq)
                    evicted.append(seq)
                continue
            active.append((seq, chunk))

        if not active:
            return None, admitted, evicted

        b = self.max_batch
        qw = max(len(chunk) for _, chunk in active)
        ps = self.pool.page_size
        sink = self.pool.sink
        tok = np.zeros((b, qw), "int64")
        pos = np.zeros((b, qw), "int32")
        page_ids = np.full((b, qw), sink, "int32")
        slots = np.zeros((b, qw), "int32")
        kv_lens = np.zeros((b,), "int32")
        q_lens = np.zeros((b,), "int32")
        tables = np.zeros((b, self.ppseq), "int32")
        temps = np.zeros((b,), "float32")
        n_prefill = n_decode = 0
        fed_prefill = fed_decode = 0
        for i, (seq, chunk) in enumerate(active):
            n = len(chunk)
            start = seq.kv_len
            tok[i, :n] = chunk
            pos[i, :n] = np.arange(start, start + n, dtype="int32")
            for j in range(n):
                p = start + j
                page_ids[i, j] = seq.pages[p // ps]
                slots[i, j] = p % ps
            kv_lens[i] = start + n
            q_lens[i] = n
            tables[i, :len(seq.pages)] = seq.pages
            temps[i] = seq.req.temperature
            if start < len(seq.req.prompt):     # still eating prompt
                n_prefill += 1
                fed_prefill += n
            else:
                n_decode += 1
                fed_decode += n
        plan = StepPlan(seqs=[s for s, _ in active], tok=tok, pos=pos, page_ids=page_ids,
                        slots=slots, kv_lens=kv_lens, q_lens=q_lens,
                        tables=tables, temps=temps,
                        n_prefill=n_prefill, n_decode=n_decode,
                        fed_prefill=fed_prefill, fed_decode=fed_decode,
                        bisect_group=group)
        return plan, admitted, evicted

    def commit(self, plan: StepPlan) -> None:
        """Mark the plan's tokens as committed to the pages (called
        after the step ran).  Sequences whose request finished while
        the step was in flight (``stop()``, a failed step) have been
        released — their pages may already be reallocated, so nothing
        is committed for them."""
        for i, seq in enumerate(plan.seqs):
            if seq.req.done:
                continue
            seq.kv_len = int(plan.kv_lens[i])

    # -- fused serving windows -------------------------------------------
    def window_budget(self, plan: StepPlan, max_steps: int):
        """How many iterations the device may run on ``plan`` without
        a host boundary: clamp ``max_steps`` to the tightest remaining
        token budget (a lane hitting its budget finishes — the window
        exits there anyway) and to what the page pool can host WITHOUT
        eviction, then pre-allocate every page the window can touch
        and refresh ``plan.tables`` so the on-device append cursors
        stay in-bounds.  Returns ``(w, clamp_reason)``; ``w == 1``
        means the single-step path (with its eviction machinery)
        should run instead — nothing was allocated."""
        w = int(max_steps)
        reason = "window_full"
        rem = min(seq.req.max_new_tokens - len(seq.req.tokens)
                  for seq in plan.seqs)
        w = min(w, max(rem, 1))
        avail = self.pool.available()
        while w > 1 and sum(self._pages_needed(s, s.kv_len + w)
                            for s in plan.seqs) > avail:
            w -= 1
            reason = "page_limit"
        if w <= 1:
            return 1, reason
        for seq in plan.seqs:
            if not self._grow(seq, seq.kv_len + w):
                # the avail math above makes this unreachable; any
                # pages already granted are owned and trimmed at the
                # next commit, so bailing to single-step is safe
                return 1, "page_limit"
        for i, seq in enumerate(plan.seqs):
            plan.tables[i, :len(seq.pages)] = seq.pages
        return w, reason

    def commit_window(self, plan: StepPlan, steps: int) -> None:
        """Commit a fused window's outcome: every surviving lane ran
        exactly ``steps`` decode iterations (no lane runs past the
        FIRST finish, so lanes never diverge mid-window).  Pages the
        clamped window reserved but never wrote are returned to the
        pool."""
        for seq in plan.seqs:
            if seq.req.done:
                continue
            seq.kv_len += int(steps)
            self._trim_pages(seq)

    def _trim_pages(self, seq: _Sequence) -> None:
        """Drop owned pages past what ``kv_len`` occupies (window
        over-allocation after an early exit).  Trailing pages are
        never prefix-cache-shared — shared pages cover only the prompt
        prefix — so a plain unref is enough."""
        keep = -(-seq.kv_len // self.pool.page_size)
        while len(seq.pages) > max(keep, 1):
            self.pool.unref(seq.pages.pop())

    def prestage_plan(self, plan: StepPlan, window: int) -> None:
        """Double-buffered plan: called right after a fused window is
        DISPATCHED (device busy, host free) — stage the next boundary's
        admission (and the perf model's price for the queue head)
        against the projected post-window state: all plan lanes
        decoding, window pages already charged to the pool, queue
        unchanged.  ``plan_step`` commits the staged work when the
        window exits exactly as projected (full run, no finishes) and
        discards it otherwise."""
        if not self.waiting:
            self._prestage = None
            return
        self.prestaged_plans += 1
        head = self.waiting[0]
        prediction = None
        if self.perf_model is not None and self.max_step_cost_s > 0:
            pred = self._predicted_admit_cost(head,
                                              projected_decode=True)
            prediction = (head.req.id, pred)
        self._prestage = _Prestage(
            running_ids=tuple(s.req.id for s in self.running),
            head_id=head.req.id,
            free_pages=self.pool.available(),
            prediction=prediction)
