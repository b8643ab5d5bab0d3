"""SLO regression watchdog over the JSONL event log; a copy of
``paddle_tpu/observability/watchdog.py``.

Computes per-kind duration baselines from historical event logs and
flags runs whose observed durations diverge beyond a tolerance band —
and closes the telemetry loop with the learned perf model
(``tuning.learned``): the records it reads are the model's training
features, and a flag is the "observed step time diverges from
prediction" signal.

Duration sources, keyed per kind:

* ``trace_span`` records key as ``trace_span:<name>`` over ``dur_s``
  (``batch_step``, ``serving_request``, ``queue``, ...);
* ``step`` records key as ``step`` over ``step_time_s``;
* ``batch_step`` records key as ``batch_step`` over ``step_s`` (the
  measured ragged-iteration seconds the learned perf model trains on);
* every other kind keys as its ``kind`` over ``dur_s`` when present.

Three gates:

* :func:`check` — observed log vs a baseline log: a key regresses when
  its observed p50 exceeds ``baseline_p50 * (1 + tolerance)`` (p90
  likewise), with at least ``min_samples`` on both sides and both
  medians above ``min_seconds`` (sub-100µs keys are scheduler jitter,
  not SLOs).
* :func:`self_check` — one log against itself: the first half of each
  key's samples is the baseline for the second half, catching mid-run
  degradation.
* :func:`model_check` — observed durations against the **learned
  performance model's predictions**: a key whose median
  observed/predicted ratio leaves the tolerance band emits a
  ``perf_regression`` event and flags the run.

CLI: ``python -m paddle_tpu_torch.observability watchdog`` — exit 0
clean, 3 on regression (``--perf-model`` switches to the
model-divergence mode).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["duration_key", "collect_durations", "summarize",
           "compute_baselines", "check", "self_check", "model_check",
           "DEFAULT_TOLERANCE", "DEFAULT_MIN_SAMPLES",
           "DEFAULT_MIN_SECONDS"]

DEFAULT_TOLERANCE = 0.5
DEFAULT_MIN_SAMPLES = 3
DEFAULT_MIN_SECONDS = 1e-4

# keys that measure BACK-PRESSURE, not work: queue wait and
# whole-request wall time scale with offered load (later arrivals in a
# burst legitimately wait longer), so gating on them turns every load
# test into a "regression".  Pass exclude=() to check them anyway.
DEFAULT_EXCLUDE = frozenset({"trace_span:queue",
                             "trace_span:serving_request"})

# kinds whose duration lives outside the envelope's dur_s
_DURATION_FIELDS = {"step": "step_time_s", "batch_step": "step_s"}


def duration_key(rec: Dict[str, Any]) -> Optional[str]:
    """The baseline bucket this record contributes to (None: no
    duration signal)."""
    kind = rec.get("kind")
    if not isinstance(kind, str):
        return None
    if kind == "trace_span":
        return f"trace_span:{rec.get('name', '?')}"
    return kind


def _duration_of(rec: Dict[str, Any]) -> Optional[float]:
    field = _DURATION_FIELDS.get(rec.get("kind"), "dur_s")
    v = rec.get(field)
    return float(v) if isinstance(v, (int, float)) else None


def collect_durations(records: List[Dict[str, Any]]
                      ) -> Dict[str, List[float]]:
    """key -> duration samples, in record order."""
    out: Dict[str, List[float]] = {}
    for rec in records:
        if not isinstance(rec, dict):
            continue
        dur = _duration_of(rec)
        if dur is None:
            continue
        key = duration_key(rec)
        if key is None:
            continue
        out.setdefault(key, []).append(dur)
    return out


def _percentile(sorted_samples: List[float], q: float) -> float:
    n = len(sorted_samples)
    idx = min(n - 1, max(0, int(round(q * (n - 1)))))
    return sorted_samples[idx]


def summarize(samples: List[float]) -> Dict[str, Any]:
    s = sorted(samples)
    return {"count": len(s),
            "mean": round(sum(s) / len(s), 6),
            "p50": round(_percentile(s, 0.5), 6),
            "p90": round(_percentile(s, 0.9), 6),
            "max": round(s[-1], 6)}


def compute_baselines(records: List[Dict[str, Any]],
                      min_samples: int = DEFAULT_MIN_SAMPLES
                      ) -> Dict[str, Dict[str, Any]]:
    """Per-key duration baselines from a historical event stream; keys
    with fewer than ``min_samples`` samples carry no baseline (one slow
    outlier must not become a permanent SLO)."""
    return {key: summarize(samples)
            for key, samples in collect_durations(records).items()
            if len(samples) >= int(min_samples)}


def check(records: List[Dict[str, Any]],
          baselines: Dict[str, Dict[str, Any]],
          tolerance: float = DEFAULT_TOLERANCE,
          min_samples: int = DEFAULT_MIN_SAMPLES,
          min_seconds: float = DEFAULT_MIN_SECONDS,
          exclude=DEFAULT_EXCLUDE) -> List[Dict[str, Any]]:
    """Flag keys whose observed p50/p90 exceed the baseline band.
    Returns one finding dict per regressed key (empty: clean)."""
    findings: List[Dict[str, Any]] = []
    band = 1.0 + float(tolerance)
    for key, samples in sorted(collect_durations(records).items()):
        base = baselines.get(key)
        if base is None or len(samples) < int(min_samples) \
                or key in (exclude or ()):
            continue
        obs = summarize(samples)
        if obs["p50"] < min_seconds and base["p50"] < min_seconds:
            continue
        regressed = []
        for stat in ("p50", "p90"):
            if obs[stat] > max(base[stat], min_seconds) * band:
                regressed.append(stat)
        if regressed:
            findings.append({
                "key": key, "stats": regressed,
                "baseline_p50": base["p50"], "observed_p50": obs["p50"],
                "baseline_p90": base["p90"], "observed_p90": obs["p90"],
                "ratio": round(obs["p50"] / base["p50"], 3)
                if base["p50"] else None,
                "baseline_count": base["count"],
                "observed_count": obs["count"]})
    return findings


def model_check(records: List[Dict[str, Any]], model,
                tolerance: float = DEFAULT_TOLERANCE,
                min_samples: int = DEFAULT_MIN_SAMPLES,
                min_seconds: float = DEFAULT_MIN_SECONDS,
                emit_events: bool = True) -> List[Dict[str, Any]]:
    """Observed durations vs the learned perf model's predictions.

    For every family the model has a head for (``batch_step`` records
    over ``step_s`` with their batch-composition features, ``step``
    records over ``step_time_s`` with their run-context features), each
    record is predicted INDIVIDUALLY and the key regresses when the
    median observed/predicted ratio exceeds ``1 + tolerance`` — so a
    run over shapes no baseline log ever saw still gets a verdict.
    Each finding also lands as a ``perf_regression`` event (when the
    event log is enabled and ``emit_events``), which is how a serving
    process self-reports divergence into its own telemetry."""
    from ..analysis import perf_features
    findings: List[Dict[str, Any]] = []
    band = 1.0 + float(tolerance)
    for family, pairs in sorted(
            perf_features.event_samples(records).items()):
        if not hasattr(model, "has") or not model.has(family):
            continue
        if len(pairs) < int(min_samples):
            continue
        obs, preds, ratios = [], [], []
        for feats, secs in pairs:
            p = model.predict(family, feats)
            if p is None or p <= 0:
                continue
            obs.append(secs)
            preds.append(p)
            ratios.append(secs / p)
        if len(ratios) < int(min_samples):
            continue
        obs_p50 = _percentile(sorted(obs), 0.5)
        pred_p50 = _percentile(sorted(preds), 0.5)
        ratio = _percentile(sorted(ratios), 0.5)
        if obs_p50 < min_seconds and pred_p50 < min_seconds:
            continue
        if ratio > band:
            finding = {
                "key": family, "stats": ["p50"],
                "observed_p50": round(obs_p50, 6),
                "predicted_p50": round(pred_p50, 6),
                "ratio": round(ratio, 3),
                "observed_count": len(obs),
                "model_version": int(getattr(model, "version", 0))}
            findings.append(finding)
            if emit_events:
                from . import events
                events.emit(
                    "perf_regression", key=family,
                    observed_p50=finding["observed_p50"],
                    predicted_p50=finding["predicted_p50"],
                    ratio=finding["ratio"], n=len(obs),
                    tolerance=float(tolerance),
                    model_version=finding["model_version"])
    return findings


def self_check(records: List[Dict[str, Any]],
               tolerance: float = DEFAULT_TOLERANCE,
               min_samples: int = DEFAULT_MIN_SAMPLES,
               min_seconds: float = DEFAULT_MIN_SECONDS,
               exclude=DEFAULT_EXCLUDE) -> List[Dict[str, Any]]:
    """One-log mode: per key, the first half of the samples (record
    order ~ time order in an append-only log) baselines the second
    half — a run that got slower as it went is flagged."""
    findings: List[Dict[str, Any]] = []
    band = 1.0 + float(tolerance)
    for key, samples in sorted(collect_durations(records).items()):
        if len(samples) < 2 * int(min_samples) \
                or key in (exclude or ()):
            continue
        mid = len(samples) // 2
        base, obs = summarize(samples[:mid]), summarize(samples[mid:])
        if obs["p50"] < min_seconds and base["p50"] < min_seconds:
            continue
        if obs["p50"] > max(base["p50"], min_seconds) * band:
            findings.append({
                "key": key, "stats": ["p50"],
                "baseline_p50": base["p50"], "observed_p50": obs["p50"],
                "baseline_p90": base["p90"], "observed_p90": obs["p90"],
                "ratio": round(obs["p50"] / base["p50"], 3)
                if base["p50"] else None,
                "baseline_count": base["count"],
                "observed_count": obs["count"]})
    return findings
