"""paddle_tpu_torch.serving — continuous-batching LLM serving on the GPU.

* :class:`~.scheduler.Scheduler` — iteration-level request admission
  over a refcounted KV page pool (mixed prefill+decode steps, immediate
  page free on EOS, eviction/requeue under page pressure);
* ``ops.ragged_paged_attention`` — the one-launch CUDA kernel that
  attends a whole ragged batch;
* :class:`~.prefix_cache.PrefixCache` — content-hashed, refcounted
  sharing of immutable prompt-prefix pages across requests;
* :class:`~.engine.ServingEngine` — the streaming front-end, over GPT or
  LLaMA; ``FLAGS_serving_fused_steps`` runs steady-state decode as
  windows with one host read each; ``inference.serving`` serves it over
  HTTP.  Its fault containment: quarantine bisection, the NaN-logits
  sentinel, the hung-step watchdog (``FLAGS_serving_step_timeout_s``),
  deadlines, the health ladder and predicted-cost admission
  (``tuning.learned``).

Quick start::

    from paddle_tpu_torch.serving import ServingEngine
    with ServingEngine(model, max_batch=8) as eng:
        req = eng.submit(prompt_ids, max_new_tokens=32, eos_token_id=2)
        for tok in req.stream():
            ...

``python -m paddle_tpu_torch.serving`` runs a self-contained demo.
"""
from .engine import ServingEngine
from .prefix_cache import PrefixCache
from .scheduler import PagePool, Request, Scheduler, StepPlan

__all__ = ["ServingEngine", "PrefixCache", "PagePool", "Request",
           "Scheduler", "StepPlan"]
