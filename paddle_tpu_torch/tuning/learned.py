"""Telemetry-fed learned performance model; a copy of
``paddle_tpu/tuning/learned.py`` (*A Learned Performance Model for
TPUs*, arXiv 2008.01040: a model trained on measured runtimes
generalizes to shapes never measured).

* :func:`fit_from_telemetry` trains one :class:`LearnedPerfModel` — a
  ridge head per sample **family** (``flash``, ``plan``, ``batch_step``,
  ``step``) in log-duration space over log-compressed features — from a
  tuning cache (may be None; the port keeps none) plus any number of
  event-log dirs.  The port's serving engine logs ``batch_step`` records
  with the measured ``step_s``, so a ``batch_step`` head fitted on the
  H100's own timings needs no other data.
* The model persists as a **versioned** JSON file (``perf_model.json``,
  monotonically bumped ``version``) in ``FLAGS_tuning_cache_dir``;
  :func:`load_model` is mtime-cached so hot paths can consult it per
  call.
* Consumers: the serving scheduler admits prefills against the predicted
  batch-step cost (``FLAGS_serving_predicted_admission``), and
  ``observability.watchdog.model_check`` flags observed-vs-predicted
  divergence (``perf_regression`` events, exit 3 from ``python -m
  paddle_tpu_torch.observability watchdog --perf-model``).

The ``flash`` and ``plan`` feature dicts include the analytic cost
terms of ``cost_model`` as a prior, as in the reference;
:func:`sanity_check` holds the learned head to beating that unfitted
baseline on a held-out fixture corpus.

Stdlib-only at import; numpy is imported inside ``fit``.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .cost_model import Coefficients, _flash_cost, _plan_cost, \
    flash_features

__all__ = [
    "MODEL_FILE", "MODEL_SCHEMA", "FAMILIES", "LearnedPerfModel",
    "flash_feature_dict", "plan_feature_dict",
    "flash_samples_from_cache", "plan_samples_from_cache",
    "fit_from_telemetry", "load_model", "save_model", "model_path",
    "sanity_check",
]

MODEL_FILE = "perf_model.json"
MODEL_SCHEMA = 1
FAMILIES = ("flash", "plan", "batch_step", "step")

# log-compress every feature around a 1e-9 floor: second-scale features
# (1e-6..1e-1 s) keep their multiplicative structure (log1p(v*1e9) ~
# ln v + 9 ln 10) while count-scale features stay monotone; the
# standardization below recenters either way
_SCALE = 1e9


def _xform(v: float) -> float:
    return math.copysign(math.log1p(abs(float(v)) * _SCALE), float(v))


def _log_target(secs: float) -> float:
    return math.log(max(float(secs), 1e-9))


def _male(pred: Sequence[float], obs: Sequence[float]) -> float:
    """Mean absolute log error — the scale-free metric every head and
    baseline is judged by."""
    errs = [abs(_log_target(p) - _log_target(o))
            for p, o in zip(pred, obs)]
    return sum(errs) / len(errs) if errs else 0.0


# ---------------------------------------------------------------------------
# feature dicts for the cache-derived families
# ---------------------------------------------------------------------------

def flash_feature_dict(sq: int, sk: int, d: int, dtype, causal: bool,
                       bq: int, bk: int, bh: int = 8) -> Dict[str, float]:
    """``cost_model.flash_features`` plus the analytic decomposition
    (the prior the learned head corrects)."""
    f = flash_features(sq, sk, d, dtype, causal, bq, bk, bh)
    c = Coefficients()
    peak = c.peak_flops * (2.0 / f["dtype_bytes"]
                           if f["dtype_bytes"] > 2 else 1.0)
    f = dict(f)
    f["t_compute"] = f["flops"] / (peak * max(f["mxu_util"], 1e-3))
    f["t_memory"] = f["hbm_bytes"] / c.hbm_bytes_per_s
    f["t_overhead"] = (f["grid_steps"] * c.grid_overhead_s
                       + f["inner_iters"] * c.iter_overhead_s)
    f["analytic_s"] = _flash_cost(f, c)
    return f


def plan_feature_dict(candidate: Sequence[int], batch_tokens: int,
                      param_bytes: int) -> Dict[str, float]:
    """(dp, sharding, mp) plan features: the mesh factorization, the
    workload scale, and the analytic roofline terms."""
    c = Coefficients()
    dp, sh, mp = (int(x) for x in candidate)
    shards = max(dp * sh * mp, 1)
    t_comp = (batch_tokens * param_bytes / 2.0) \
        / (shards * c.ici_flops_per_byte)
    n = dp * sh
    t_dp = 2.0 * (n - 1) / n * (param_bytes / mp) if n > 1 else 0.0
    t_mp = 2.0 * (mp - 1) / mp * (4.0 * batch_tokens / n) * 8 \
        if mp > 1 else 0.0
    return {"dp": float(dp), "sharding": float(sh), "mp": float(mp),
            "shards": float(shards),
            "batch_tokens": float(batch_tokens),
            "param_bytes": float(param_bytes),
            "t_compute": t_comp, "t_dp_ring": t_dp, "t_mp_act": t_mp,
            "analytic_s": _plan_cost((dp, sh, mp), batch_tokens,
                                     param_bytes, c)}


# ---------------------------------------------------------------------------
# one ridge head per family
# ---------------------------------------------------------------------------

class _Head:
    """Ridge regression in log-duration space over log-compressed,
    standardized features.  Serializable; predicts with stdlib math."""

    def __init__(self, family: str, feature_names: List[str],
                 mu: List[float], sd: List[float], w: List[float],
                 b: float, stats: Dict[str, Any]):
        self.family = family
        self.feature_names = list(feature_names)
        self.mu = list(mu)
        self.sd = list(sd)
        self.w = list(w)
        self.b = float(b)
        self.stats = dict(stats)

    # -- training ---------------------------------------------------------
    @classmethod
    def fit(cls, family: str,
            samples: Sequence[Tuple[Dict[str, float], float]],
            l2: float = 1e-3,
            baseline: Optional[Callable[[Dict[str, float]], float]]
            = None) -> "_Head":
        """Fit on ``[(features, seconds), ...]``.  A deterministic
        every-4th holdout (when >= 12 samples) scores the head and the
        baseline predictor; with fewer samples the score is in-sample.
        ``baseline`` defaults to the ``analytic_s`` feature when
        present, else the train-set geometric mean."""
        import numpy as np
        if len(samples) < 4:
            raise ValueError(f"{family}: fit needs >= 4 samples, "
                             f"got {len(samples)}")
        names = sorted({k for f, _ in samples for k in f})
        X = np.asarray([[_xform(f.get(k, 0.0)) for k in names]
                        for f, _ in samples], dtype=float)
        y = np.asarray([_log_target(s) for _, s in samples],
                       dtype=float)
        idx = np.arange(len(samples))
        hold = idx[idx % 4 == 3] if len(samples) >= 12 else idx
        train = idx[idx % 4 != 3] if len(samples) >= 12 else idx
        mu = X[train].mean(axis=0)
        sd = X[train].std(axis=0)
        sd = np.where(sd < 1e-9, 1.0, sd)
        Z = (X[train] - mu) / sd
        n, k = Z.shape
        # ridge via augmented least squares; the bias column is not
        # regularized (a shifted target must not shrink toward 0)
        A = np.vstack([np.hstack([Z, np.ones((n, 1))]),
                       np.hstack([math.sqrt(l2) * np.eye(k),
                                  np.zeros((k, 1))])])
        t = np.concatenate([y[train], np.zeros(k)])
        sol, *_ = np.linalg.lstsq(A, t, rcond=None)
        w, b = sol[:k], float(sol[k])

        def predict_row(row) -> float:
            z = (row - mu) / sd
            return float(min(max(math.exp(float(z @ w) + b), 1e-9),
                             1e6))

        preds = [predict_row(X[i]) for i in hold]
        obs = [math.exp(y[i]) for i in hold]
        if baseline is None:
            if "analytic_s" in names:
                def baseline(f):
                    return f.get("analytic_s", 0.0)
            else:
                gm = math.exp(float(y[train].mean()))

                def baseline(_f, _gm=gm):
                    return _gm
        base_preds = [max(float(baseline(samples[i][0])), 1e-9)
                      for i in hold]
        stats = {
            "n_samples": len(samples), "n_train": int(len(train)),
            "n_holdout": int(len(hold)),
            "in_sample": bool(len(samples) < 12),
            "holdout_male": round(_male(preds, obs), 6),
            "baseline_male": round(_male(base_preds, obs), 6),
        }
        stats["improved"] = stats["holdout_male"] \
            < stats["baseline_male"]
        return cls(family, names, [float(v) for v in mu],
                   [float(v) for v in sd], [float(v) for v in w], b,
                   stats)

    # -- inference (stdlib-only) ------------------------------------------
    def predict(self, features: Dict[str, float]) -> float:
        acc = self.b
        for name, mu, sd, w in zip(self.feature_names, self.mu,
                                   self.sd, self.w):
            acc += w * ((_xform(features.get(name, 0.0)) - mu) / sd)
        return min(max(math.exp(acc), 1e-9), 1e6)

    def to_dict(self) -> dict:
        return {"family": self.family,
                "feature_names": self.feature_names, "mu": self.mu,
                "sd": self.sd, "w": self.w, "b": self.b,
                "stats": self.stats}

    @classmethod
    def from_dict(cls, d: dict) -> "_Head":
        return cls(d["family"], d["feature_names"], d["mu"], d["sd"],
                   d["w"], d["b"], d.get("stats", {}))


class LearnedPerfModel:
    """A set of per-family heads + versioning metadata."""

    def __init__(self, heads: Optional[Dict[str, _Head]] = None,
                 version: int = 0, created_ts: float = 0.0):
        self.heads = dict(heads or {})
        self.version = int(version)
        self.created_ts = float(created_ts)

    def has(self, family: str) -> bool:
        return family in self.heads

    def predict(self, family: str, features: Dict[str, float]
                ) -> Optional[float]:
        head = self.heads.get(family)
        if head is None:
            return None
        try:
            return head.predict(features)
        except Exception:
            return None     # a malformed model must never break a caller

    # -- family-shaped conveniences ---------------------------------------
    def flash_seconds(self, sq, sk, d, dtype, causal, bq, bk, bh=8
                      ) -> Optional[float]:
        return self.predict("flash", flash_feature_dict(
            sq, sk, d, dtype, causal, bq, bk, bh))

    def rank_flash_candidates(self, candidates, sq, sk, d, dtype,
                              causal, bh=8) -> List[Tuple[int, int]]:
        cands = list(candidates)
        return sorted(cands, key=lambda c: self.flash_seconds(
            sq, sk, d, dtype, causal, c[0], c[1], bh) or float("inf"))

    def plan_seconds(self, candidate, batch_tokens, param_bytes
                     ) -> Optional[float]:
        return self.predict("plan", plan_feature_dict(
            candidate, batch_tokens, param_bytes))

    def batch_step_seconds(self, features: Dict[str, float]
                           ) -> Optional[float]:
        return self.predict("batch_step", features)

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": MODEL_SCHEMA, "version": self.version,
                "created_ts": self.created_ts,
                "heads": {k: h.to_dict()
                          for k, h in sorted(self.heads.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "LearnedPerfModel":
        if d.get("schema") != MODEL_SCHEMA:
            raise ValueError(f"perf model schema "
                             f"{d.get('schema')!r} != {MODEL_SCHEMA}")
        return cls({k: _Head.from_dict(h)
                    for k, h in d.get("heads", {}).items()},
                   version=d.get("version", 0),
                   created_ts=d.get("created_ts", 0.0))


# ---------------------------------------------------------------------------
# the versioned model file (FLAGS_tuning_cache_dir)
# ---------------------------------------------------------------------------

# path -> (mtime, model-or-None): hot paths (flash_blocks, admission)
# consult the model per call; a stat is cheap, a JSON parse is not
_LOADED: Dict[str, Tuple[float, Optional[LearnedPerfModel]]] = {}


def model_path(directory: str) -> str:
    return os.path.join(os.path.abspath(directory), MODEL_FILE)


def _resolve_dir(directory: Optional[str]) -> Optional[str]:
    if directory:
        return directory
    try:
        from ..flags import get_flag
        return get_flag("tuning_cache_dir") or None
    except Exception:
        return None


def load_model(directory: Optional[str] = None
               ) -> Optional[LearnedPerfModel]:
    """The persisted model under ``directory`` (default
    ``FLAGS_tuning_cache_dir``), or None (missing dir/file, corrupt
    file — the caller falls back to the analytic model)."""
    directory = _resolve_dir(directory)
    if not directory:
        return None
    path = model_path(directory)
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        _LOADED.pop(path, None)
        return None
    hit = _LOADED.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    try:
        with open(path, "r", encoding="utf-8") as fh:
            model = LearnedPerfModel.from_dict(json.load(fh))
    except Exception:   # corrupt/foreign file degrades to analytic
        model = None
    _LOADED[path] = (mtime, model)
    return model


def save_model(model: LearnedPerfModel, directory: str) -> str:
    """Atomic versioned write: the on-disk version (if any) bumps by
    one; emits a ``perf_model`` event."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = model_path(directory)
    prev = load_model(directory)
    model.version = (prev.version if prev is not None else 0) + 1
    model.created_ts = time.time()  # noqa: PTL501 — file metadata
    # (model age stamp), not a reported timing
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(model.to_dict(), fh, sort_keys=True)
    os.replace(tmp, path)
    _LOADED.pop(path, None)
    from ..observability import events
    events.emit("perf_model", action="save", version=model.version,
                heads=sorted(model.heads),
                samples={k: h.stats.get("n_samples", 0)
                         for k, h in model.heads.items()},
                path=path)
    return path


# ---------------------------------------------------------------------------
# samples from the tuning cache (the event-log side lives in
# analysis.perf_features)
# ---------------------------------------------------------------------------

def flash_samples_from_cache(cache
                             ) -> List[Tuple[Dict[str, float], float]]:
    """(features, seconds) from the measured timing tables the
    autotuner persists in ``flash_blocks`` entries."""
    samples: List[Tuple[Dict[str, float], float]] = []
    for rec in cache.entries("flash_blocks"):
        key, timings = rec["key"], rec["value"].get("timings_ms")
        if not timings:
            continue
        for blocks, ms in timings.items():
            if not isinstance(ms, (int, float)):
                continue              # "error: ..." rows
            try:
                bq, bk = (int(p) for p in blocks.split("x"))
            except ValueError:
                continue
            samples.append((flash_feature_dict(
                key["sq"], key["sk"], key["d"], key["dtype"],
                key["causal"], bq, bk, key.get("bh_bucket", 8)),
                ms / 1e3))
    return samples


def plan_samples_from_cache(cache
                            ) -> List[Tuple[Dict[str, float], float]]:
    """(features, seconds) from ``engine_plan`` entries whose report
    rows carry measured ``step_s`` (entries written since this PR also
    carry the workload scale the features need)."""
    samples: List[Tuple[Dict[str, float], float]] = []
    for rec in cache.entries("engine_plan"):
        val = rec["value"]
        bt = val.get("batch_tokens")
        pb = val.get("param_bytes")
        if not bt or not pb:
            continue                  # pre-PR entry: scale unknown
        for row in val.get("report", []):
            secs = row.get("step_s")
            if not isinstance(secs, (int, float)) or secs <= 0:
                continue
            try:
                cand = (int(row["dp"]), int(row["sharding"]),
                        int(row["mp"]))
            except (KeyError, TypeError, ValueError):
                continue
            samples.append((plan_feature_dict(cand, bt, pb),
                            float(secs)))
    return samples


# ---------------------------------------------------------------------------
# end-to-end training
# ---------------------------------------------------------------------------

def fit_from_telemetry(cache, event_dirs: Sequence[str] = (),
                       min_samples: int = 8, l2: float = 1e-3
                       ) -> Tuple[LearnedPerfModel, Dict[str, Any]]:
    """Train every family with enough samples from ``cache`` (may be
    None) + the event logs under ``event_dirs``.  Returns (model,
    per-family summary); families short on data are reported as
    skipped, never guessed."""
    from ..analysis import perf_features
    samples: Dict[str, List[Tuple[Dict[str, float], float]]] = {
        f: [] for f in FAMILIES}
    if cache is not None:
        samples["flash"].extend(flash_samples_from_cache(cache))
        samples["plan"].extend(plan_samples_from_cache(cache))
    records: List[dict] = []
    from ..observability.events import read_events
    for d in event_dirs:
        records.extend(read_events(d))
    for fam, ss in perf_features.event_samples(records).items():
        samples[fam].extend(ss)
    model = LearnedPerfModel()
    summary: Dict[str, Any] = {}
    for fam in FAMILIES:
        ss = samples[fam]
        if len(ss) < max(int(min_samples), 4):
            summary[fam] = {"skipped":
                            f"{len(ss)} sample(s) < {min_samples}"}
            continue
        head = _Head.fit(fam, ss, l2=l2)
        model.heads[fam] = head
        summary[fam] = dict(head.stats)
    return model, summary


# ---------------------------------------------------------------------------
# the fixture-corpus sanity gate
# ---------------------------------------------------------------------------

_FIXTURE_SHAPES = [
    (128, 128, 64, "float32", True, 4),
    (256, 256, 64, "float32", False, 8),
    (512, 512, 64, "bfloat16", True, 8),
    (1024, 1024, 64, "bfloat16", True, 16),
    (1024, 1024, 128, "float32", True, 8),
    (2048, 2048, 64, "bfloat16", False, 8),
    (2048, 2048, 128, "bfloat16", True, 8),
]
_FIXTURE_BLOCKS = [(128, 128), (128, 256), (256, 128), (256, 256),
                   (128, 512), (512, 128), (64, 128), (128, 64)]


def _fixture_corpus() -> List[Tuple[Dict[str, float], float]]:
    """Deterministic synthetic ground truth: the analytic terms under
    alphas the unfitted model does NOT have (a 'machine' whose memory
    is faster and whose overheads are heavier than the datasheet),
    plus +-10% hash jitter so the fit can't be degenerate."""
    import hashlib
    out = []
    for sq, sk, d, dt, causal, bh in _FIXTURE_SHAPES:
        for bq, bk in _FIXTURE_BLOCKS:
            f = flash_feature_dict(sq, sk, d, dt, causal, bq, bk, bh)
            gt = (2.3 * f["t_compute"] + 0.55 * f["t_memory"]
                  + 3.5 * f["t_overhead"])
            seed = hashlib.sha256(
                f"{sq},{sk},{d},{dt},{causal},{bh},{bq},{bk}"
                .encode()).digest()
            jitter = 0.9 + 0.2 * (seed[0] / 255.0)
            out.append((f, gt * jitter))
    return out


def sanity_check() -> List[str]:
    """Violation strings (empty = healthy): the learned head must fit
    the fixture corpus, beat the unfitted analytic baseline on the
    held-out quarter, and survive a JSON round trip."""
    bad: List[str] = []
    corpus = _fixture_corpus()
    if len(corpus) < 40:
        bad.append(f"fixture corpus too small ({len(corpus)})")
        return bad
    try:
        head = _Head.fit("flash", corpus)
    except Exception as e:  # noqa: BLE001 — the gate reports, never raises
        return [f"fixture fit failed: {type(e).__name__}: {e}"]
    st = head.stats
    for f, _secs in corpus:
        p = head.predict(f)
        if not (math.isfinite(p) and p > 0):
            bad.append("non-finite/non-positive learned prediction")
            break
    if st["in_sample"]:
        bad.append("fixture corpus did not produce a holdout split")
    if st["holdout_male"] >= 0.9 * st["baseline_male"]:
        bad.append(
            "learned model does not beat the unfitted analytic "
            f"baseline on the held-out fixture corpus (learned MALE "
            f"{st['holdout_male']} vs analytic {st['baseline_male']})")
    model = LearnedPerfModel({"flash": head}, version=1)
    try:
        clone = LearnedPerfModel.from_dict(
            json.loads(json.dumps(model.to_dict())))
    except Exception as e:  # noqa: BLE001 — the gate reports, never raises
        return bad + [f"model round-trip failed: {e}"]
    f0 = corpus[0][0]
    a, b = model.predict("flash", f0), clone.predict("flash", f0)
    if a is None or b is None or abs(a - b) > 1e-9 * max(a or 1, 1):
        bad.append("round-tripped model predicts differently")
    return bad
