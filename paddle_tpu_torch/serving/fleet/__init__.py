"""``paddle_tpu_torch.serving.fleet`` — the multi-replica serving tier,
ported from ``paddle_tpu/serving/fleet/``.

One :class:`~paddle_tpu_torch.serving.ServingEngine` process is the
single-process ceiling; this package multiplies it:

* :mod:`~paddle_tpu_torch.serving.fleet.replica` — a supervisor launching
  and monitoring N engine processes (restart cap, deterministic
  backoff, SIGTERM-grace, drain-aware rolling restarts);
* :mod:`~paddle_tpu_torch.serving.fleet.router` — an HTTP front-end with
  the same ``POST /generate`` NDJSON contract, placing each request
  by prefix-cache affinity → least predicted cost (merged perf
  model) → least queue depth, resubmitting mid-stream work from a
  dead replica to a survivor with generated-so-far tokens kept;
* :mod:`~paddle_tpu_torch.serving.fleet.perf_merge` — the sample-weighted
  merge of per-replica ``perf_model.json`` files that makes the
  learned performance model fleet-wide.

``python -m paddle_tpu_torch.serving.fleet --replicas 2`` runs a live
demo at GPT-3 1.3B's widths on the card (``--device cpu`` and tiny
widths on the CPU); the same entry with ``--worker`` is the per-replica
process the supervisor launches.
"""
from .perf_merge import merge_heads, merge_models, save_merged
from .replica import ReplicaHandle, ReplicaSupervisor
from .router import FleetRouter

__all__ = ["FleetRouter", "ReplicaHandle", "ReplicaSupervisor",
           "merge_heads", "merge_models", "save_merged"]
