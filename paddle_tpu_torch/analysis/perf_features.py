"""Feature extraction from production telemetry for the learned
performance model (``paddle_tpu_torch.tuning.learned``); a copy of
``paddle_tpu/analysis/perf_features.py`` without ``jaxpr_features``
(it flattens a live jaxpr, which the port has none of).

Two feature sources, both from the JSONL event log
(``observability.events``):

* **batch composition** — ``batch_step`` records carry the ragged
  serving iteration's shape (batch, prefill/decode split, q width,
  fed tokens, queue depth, page occupancy) and the measured step
  duration (``step_s``) — a (features, seconds) sample per iteration.
* **run context** — per ``run`` id: the op-class histogram of every
  ``dispatch_summary`` in the run (ops classified by
  ``tuning.cost_model.classify_primitive``) plus the summed
  ``graph_pass`` op-class deltas.  ``step`` records inherit their run's
  context as features against their ``step_time_s`` target.  (The port
  emits neither kind yet; logs of the JAX package featurize alike.)

Everything returns plain ``{name: float}`` dicts (stable names, no
NaN/None values — missing optional fields default to 0.0) so the model
layer can build matrices without guessing.  Stdlib-only at import.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "OP_CLASSES", "BATCH_STEP_FIELDS", "STEP_CONTEXT_FIELDS",
    "batch_step_features", "run_context_features",
    "batch_step_samples", "step_samples", "event_samples",
    "training_matrix",
]

# the shared op-class vocabulary (tuning.cost_model._OP_CLASSES keys +
# the default class) — fixed order so every feature row lines up
OP_CLASSES = ("matmul", "reduce", "gather_scatter", "collective",
              "control", "elementwise")

# batch_step record fields that become features, in row order.
# page_occupancy and fused_steps are optional on old logs (a record
# predating them was a single-step iteration on an unknown pool, so
# fused_steps defaults 1.0 and page_occupancy 0.0); the rest are
# required — a record missing one yields no sample.
BATCH_STEP_FIELDS = ("batch", "prefill_seqs", "decode_seqs", "q_width",
                     "tokens", "queue_depth")
_BATCH_STEP_OPTIONAL = ("page_occupancy", "fused_steps")
_BATCH_STEP_DEFAULTS = {"page_occupancy": 0.0, "fused_steps": 1.0}

STEP_CONTEXT_FIELDS = tuple(f"ops_{c}" for c in OP_CLASSES) + (
    "ops_total", "host_transfers", "graph_pass_removed")


def _num(v: Any) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def _classify(name: str) -> str:
    from ..tuning.cost_model import classify_primitive
    return classify_primitive(name)


def batch_step_features(rec: Dict[str, Any]) -> Optional[Dict[str, float]]:
    """Feature dict for one ``batch_step`` record, or None when a
    required field is missing/non-numeric."""
    out: Dict[str, float] = {}
    for f in BATCH_STEP_FIELDS:
        v = _num(rec.get(f))
        if v is None:
            return None
        out[f] = v
    for f in _BATCH_STEP_OPTIONAL:
        v = _num(rec.get(f))
        out[f] = v if v is not None else _BATCH_STEP_DEFAULTS[f]
    return out


def run_context_features(records: List[Dict[str, Any]]
                         ) -> Dict[str, Dict[str, float]]:
    """Per-run-id context features: summed op-class dispatch counts
    (``dispatch_summary``) + summed ``graph_pass`` removals."""
    out: Dict[str, Dict[str, float]] = {}

    def ctx(run: str) -> Dict[str, float]:
        c = out.get(run)
        if c is None:
            c = {f: 0.0 for f in STEP_CONTEXT_FIELDS}
            out[run] = c
        return c

    for rec in records:
        if not isinstance(rec, dict):
            continue
        run = str(rec.get("run", "?"))
        kind = rec.get("kind")
        if kind == "dispatch_summary":
            c = ctx(run)
            for op, n in (rec.get("ops") or {}).items():
                v = _num(n)
                if v is None:
                    continue
                c[f"ops_{_classify(str(op))}"] += v
                c["ops_total"] += v
            ht = _num(rec.get("host_transfers"))
            if ht is not None:
                c["host_transfers"] += ht
        elif kind == "graph_pass":
            c = ctx(run)
            removed = _num(rec.get("removed"))
            if removed is not None:
                c["graph_pass_removed"] += removed
            for cls, n in (rec.get("op_class_delta") or {}).items():
                v = _num(n)
                if v is not None and f"ops_{cls}" in c:
                    # ops the pipeline removed still describe the
                    # program's shape — count them into the class mix
                    c[f"ops_{cls}"] += abs(v)
    return out


# ---------------------------------------------------------------------------
# (features, seconds) sample extraction
# ---------------------------------------------------------------------------

def batch_step_samples(records: List[Dict[str, Any]]
                       ) -> List[Tuple[Dict[str, float], float]]:
    """``batch_step`` records with a measured ``step_s`` duration."""
    out = []
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "batch_step":
            continue
        if rec.get("cold_start"):
            # program-cache-miss steps time trace+compile, not work —
            # training (or judging divergence) on them would teach the
            # model that the first step of every Q bucket takes 1000x
            continue
        secs = _num(rec.get("step_s"))
        if secs is None or secs <= 0:
            continue
        feats = batch_step_features(rec)
        if feats is not None:
            out.append((feats, secs))
    return out


def step_samples(records: List[Dict[str, Any]]
                 ) -> List[Tuple[Dict[str, float], float]]:
    """``step`` records against their run's context features."""
    ctx = run_context_features(records)
    out = []
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "step":
            continue
        secs = _num(rec.get("step_time_s"))
        if secs is None or secs <= 0:
            continue
        run = str(rec.get("run", "?"))
        feats = dict(ctx.get(run)
                     or {f: 0.0 for f in STEP_CONTEXT_FIELDS})
        out.append((feats, secs))
    return out


def event_samples(records: List[Dict[str, Any]]
                  ) -> Dict[str, List[Tuple[Dict[str, float], float]]]:
    """Every event-log-derived sample family the learned model trains
    on (cache-derived families — flash, plan — live in
    ``tuning.learned``)."""
    return {"batch_step": batch_step_samples(records),
            "step": step_samples(records)}


def training_matrix(records: List[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, Any]]:
    """Dense per-family training matrices from an event stream:
    ``{family: {"feature_names": [...], "rows": [[...]], "targets":
    [...]}}`` with every cell a finite float (the schema-round-trip
    test's contract)."""
    out: Dict[str, Dict[str, Any]] = {}
    for family, samples in event_samples(records).items():
        if not samples:
            continue
        names = sorted(samples[0][0])
        rows = [[float(f.get(n, 0.0)) for n in names]
                for f, _ in samples]
        out[family] = {"feature_names": names, "rows": rows,
                       "targets": [float(y) for _, y in samples]}
    return out
