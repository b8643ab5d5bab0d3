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
(``_bucket``), as in the JAX engine.

Not ported yet (later slices): fused multi-step windows, the hung-step
watchdog and relaunch, quarantine bisection, deadlines, perf-model
admission, tracing, events and metrics.  A step that raises fails the
requests of its batch, loudly; the engine keeps serving the rest.
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
from ..ops import ragged_paged_attention as _rpa
from .prefix_cache import PrefixCache
from .scheduler import PagePool, Request, Scheduler

__all__ = ["ServingEngine"]

_ENGINE_SEQ = itertools.count(1)
_POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bucket(n: int) -> int:
    """Next power of two >= n — bounds the number of distinct step
    shapes to log2(max prompt length)."""
    b = 1
    while b < n:
        b <<= 1
    return b


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
        n_layers = len(self._params["blocks"])
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
            for _ in range(n_layers)]
        self._gen = generator(seed, self.device)
        self.engine_id = str(next(_ENGINE_SEQ))
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._accepting = False
        self.health = "ok"          # "failed" once the loop dies or wedges
        # counters (written by the loop thread under self._lock)
        self._steps = 0
        self._dispatches = 0
        self._prefill_tokens = 0    # prompt tokens whose KV was built
        self._decode_tokens = 0     # tokens generated
        self._kernel_launches = 0
        self._failed_steps = 0
        self._prefill_steps = 0     # steps that fed any prompt tokens
        self._prefill_step_s = 0.0
        self._decode_step_s = 0.0

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
                with self._lock:
                    self.health = "failed"
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
        ``id`` is ``request_id`` when given).  ``trace`` (a parent span)
        and ``deadline_s`` wait for a later slice and raise
        ``NotImplementedError`` when given."""
        if trace is not None:
            raise NotImplementedError("request tracing waits for a later "
                                      "slice")
        req = Request(input_ids, max_new_tokens=max_new_tokens,
                      eos_token_id=(self.default_eos if eos_token_id
                                    is None else eos_token_id),
                      temperature=temperature, request_id=request_id,
                      deadline_s=deadline_s)
        req._cancel_cb = self._cancel_request
        with self._wake:
            if not self._accepting:
                req._finish(error="engine is not accepting requests")
                return req
            self.scheduler.submit(req)
            self._wake.notify()
        return req

    def _cancel_request(self, req, reason: str) -> None:
        with self._wake:
            if not req.done:
                self.scheduler.drop(req, error=reason)

    def _fail_all_locked(self, error: str) -> None:
        leftovers = list(self.scheduler.waiting) \
            + list(self.scheduler.running)
        self.scheduler.waiting.clear()
        for seq in leftovers:
            self.scheduler.finish(seq, error=error)

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
                self.health = "failed"
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
                plan, _, _ = self.scheduler.plan_step()
            if plan is None:
                # runnable work exists but no pages/slots right now
                time.sleep(0.005)
                continue
            try:
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

    def _run_step(self, plan):
        qw = _bucket(plan.tok.shape[1])
        pad = ((0, 0), (0, qw - plan.tok.shape[1]))
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        launches0 = _rpa.launches
        t0 = time.perf_counter()  # noqa: PTL501 — no metrics registry in the port yet; stats() reports the sums
        with torch.no_grad():
            logits, _ = self._step_fn(
                self._params, put(np.pad(plan.tok, pad)),
                put(np.pad(plan.pos, pad)), self._pools,
                put(np.pad(plan.page_ids, pad,
                           constant_values=self.pool.sink)),
                put(np.pad(plan.slots, pad)), put(plan.kv_lens),
                put(plan.q_lens), put(plan.tables))
            nxt = self._sample(logits, put(plan.temps))
            # THE device read of the step: admission, eviction and EOS
            # all key off it
            toks = nxt.cpu().numpy()  # noqa: PTL701 — the one read per step
        step_s = time.perf_counter() - t0  # noqa: PTL501 — see t0
        launched = _rpa.launches - launches0
        with self._wake:
            self.scheduler.commit(plan)
            self._steps += 1
            # host clock around dispatch + the read that waits for it
            if plan.n_prefill:
                self._prefill_steps += 1
                self._prefill_step_s += step_s
            else:
                self._decode_step_s += step_s
            self._dispatches += 1
            self._kernel_launches += launched
            self._prefill_tokens += plan.fed_prefill
            for i, seq in enumerate(plan.seqs):
                if seq.req.done:
                    continue        # finished (stop()/cancel) mid-step
                if seq.kv_len < len(seq.tokens):
                    continue        # chunked prefill still in flight
                req = seq.req
                tok_i = int(toks[i])
                if tok_i < 0:
                    # NaN-logits sentinel: this lane alone fails —
                    # co-batched lanes never mix activations
                    self.scheduler.finish(
                        seq, error="NaN logits: request failed")
                    continue
                seq.tokens.append(tok_i)
                req._emit(tok_i)
                self._decode_tokens += 1
                eos = req.eos_token_id
                if (eos is not None and tok_i == eos) or \
                        len(req.tokens) >= req.max_new_tokens:
                    if self.prefix_cache is not None and \
                            not seq.cache_inserted:
                        self._cache_prompt(seq)
                    self.scheduler.finish(seq)
                elif self.prefix_cache is not None and \
                        not seq.cache_inserted:
                    self._cache_prompt(seq)

    def _sample(self, logits, temps):
        """Next token per lane, on the device: argmax where
        ``temperature == 0``, else a categorical draw on
        ``logits / max(t, 1e-6)`` (Gumbel-max, from the engine's
        generator).  A lane whose logits hold a NaN gets -1."""
        logits = logits.float()
        greedy = logits.argmax(dim=-1)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
        scaled = logits / temps.clamp_min(1e-6)[:, None]
        sampled = (scaled + gumbel).argmax(dim=-1)
        nxt = torch.where(temps > 0, sampled, greedy)
        nxt = torch.where(torch.isnan(logits).any(dim=-1),
                          torch.full_like(nxt, -1), nxt)
        return nxt.to(torch.int32)

    def _cache_prompt(self, seq):
        """Share the finished prompt's full pages through the prefix
        cache (once per admission; pages the sequence itself borrowed
        from the cache are skipped)."""
        self.prefix_cache.insert(seq.req.prompt, seq.pages,
                                 shared=seq.shared)
        seq.cache_inserted = True

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = {"engine": self.engine_id,
                   "device": str(self.device),
                   "queue_depth": self.scheduler.queue_depth(),
                   "running": len(self.scheduler.running),
                   "steps": self._steps,
                   "dispatches": self._dispatches,
                   "prefill_tokens": self._prefill_tokens,
                   "decode_tokens": self._decode_tokens,
                   "evictions": self.scheduler.evictions,
                   "prefill_steps": self._prefill_steps,
                   "prefill_step_s": self._prefill_step_s,
                   "decode_step_s": self._decode_step_s,
                   "kernel_launches": self._kernel_launches,
                   "failed_steps": self._failed_steps,
                   "free_pages": self.pool.available()}
            if self.prefix_cache is not None:
                out["prefix_cache"] = self.prefix_cache.stats()
        return out
