"""Cross-process merge of per-replica ``perf_model.json`` files; a copy
of ``paddle_tpu/serving/fleet/perf_merge.py``.

Every replica fits its own :class:`~paddle_tpu_torch.tuning.learned.
LearnedPerfModel` from the telemetry IT saw — N engines, N ridge
heads per family, each trained on a different slice of the traffic.
The fleet router needs ONE model to score placement with, and offline
fleet analysis wants the same thing for merged logs.  This module
folds the per-replica heads into a single head per family.

The math: a head's prediction is ``exp(sum_i w_i * ((xform(x_i) -
mu_i) / sd_i) + b)`` — affine in transformed-feature space.  Rewriting
each head in canonical form (``a_i = w_i / sd_i``, intercept ``c = b -
sum_i w_i * mu_i / sd_i``) makes heads directly addable over the UNION
of their feature names (a feature a head never saw gets coefficient
0, exactly matching its own ``features.get(name, 0.0)`` behavior...
almost: the head would transform-and-standardize the 0 — canonical
form keeps the prediction bit-identical for the features it DOES
know).  The merged head is the sample-count-weighted average of the
canonical coefficients, i.e. the weighted *geometric mean* of the
source heads' predictions — the right ensemble for a log-space model:
a replica that trained on 10x the samples pulls the merged estimate
10x harder, and no replica's outliers dominate linearly.

Version semantics: the merged model's version is ``max(source
versions) + 1`` so a router comparing model files always prefers the
merge over any single input, and a re-merge after one replica refits
bumps again.  :func:`save_merged` writes atomically (tmp +
``os.replace``) like ``learned.save_model``.

Stdlib-only at import (no numpy): usable from the
``python -m paddle_tpu_torch.tuning merge`` CLI on a machine with nothing
but the JSON files.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ...tuning import learned as _learned
from ...tuning.learned import LearnedPerfModel, _Head

__all__ = ["merge_heads", "merge_models", "load_models", "save_merged"]


def _canonical(head: _Head) -> Tuple[Dict[str, float], float]:
    """(coefficients-by-feature-name, intercept) with mu=0 / sd=1."""
    coef: Dict[str, float] = {}
    c = float(head.b)
    for name, mu, sd, w in zip(head.feature_names, head.mu, head.sd,
                               head.w):
        sd = float(sd) if abs(float(sd)) > 1e-12 else 1.0
        a = float(w) / sd
        coef[name] = coef.get(name, 0.0) + a
        c -= a * float(mu)
    return coef, c


def _weight(head: _Head) -> float:
    try:
        n = float(head.stats.get("n_samples", 1))
    except (TypeError, ValueError):
        n = 1.0
    return max(n, 1.0)


def merge_heads(heads: Sequence[_Head]) -> _Head:
    """Weighted-average merge of same-family ridge heads (weights =
    training-sample counts).  The result predicts the weighted
    geometric mean of the sources' predictions."""
    if not heads:
        raise ValueError("merge_heads needs at least one head")
    family = heads[0].family
    for h in heads[1:]:
        if h.family != family:
            raise ValueError(f"cannot merge families "
                             f"{family!r} and {h.family!r}")
    if len(heads) == 1:
        h = heads[0]
        return _Head(h.family, h.feature_names, h.mu, h.sd, h.w, h.b,
                     dict(h.stats))
    total = sum(_weight(h) for h in heads)
    names = sorted({n for h in heads for n in h.feature_names})
    coef = {n: 0.0 for n in names}
    intercept = 0.0
    for h in heads:
        lam = _weight(h) / total
        c_h, b_h = _canonical(h)
        for n, a in c_h.items():
            coef[n] += lam * a
        intercept += lam * b_h
    stats = {
        "n_samples": int(total),
        "merged_from": len(heads),
        "source_samples": [int(_weight(h)) for h in heads],
    }
    return _Head(family, names, mu=[0.0] * len(names),
                 sd=[1.0] * len(names), w=[coef[n] for n in names],
                 b=intercept, stats=stats)


def merge_models(models: Sequence[LearnedPerfModel]
                 ) -> LearnedPerfModel:
    """One model whose per-family heads are the weighted merges of
    every source model that has that family.  Version is
    ``max(source versions) + 1``."""
    models = [m for m in models if m is not None]
    if not models:
        raise ValueError("merge_models needs at least one model")
    families = sorted({fam for m in models for fam in m.heads})
    heads: Dict[str, _Head] = {}
    for fam in families:
        heads[fam] = merge_heads([m.heads[fam] for m in models
                                  if fam in m.heads])
    version = max(int(m.version) for m in models) + 1
    # the merge is as fresh as its newest input (no wall-clock read:
    # a merge of stale models must not look newly fitted)
    created = max(float(m.created_ts) for m in models)
    return LearnedPerfModel(heads, version=version, created_ts=created)


def load_models(paths: Sequence[str]) -> List[LearnedPerfModel]:
    """Parse ``perf_model.json`` files; a missing or corrupt file
    raises (the CLI caller reports it — a silent skip would merge a
    different fleet than the operator named)."""
    out = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as fh:
            out.append(LearnedPerfModel.from_dict(json.load(fh)))
    return out


def save_merged(model: LearnedPerfModel, out_path: str) -> str:
    """Atomic write of a merged model to an explicit file path (the
    version is already set by :func:`merge_models` — unlike
    ``learned.save_model`` this does not re-bump from the
    destination)."""
    out_path = os.path.abspath(out_path)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(model.to_dict(), fh, sort_keys=True)
    os.replace(tmp, out_path)
    _learned._LOADED.pop(out_path, None)
    return out_path


def merged_from_dirs(dirs: Sequence[str]
                     ) -> Optional[LearnedPerfModel]:
    """Router-side convenience: merge whatever ``perf_model.json``
    files currently exist under ``dirs`` (each replica's tuning-cache
    dir).  Missing/corrupt files are skipped here — the fleet keeps
    routing on the replicas that do report; returns None when none
    do."""
    models = [m for m in (_learned.load_model(d) for d in dirs)
              if m is not None]
    if not models:
        return None
    return merge_models(models)
