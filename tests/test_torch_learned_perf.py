"""The learned performance model copied into the port
(``paddle_tpu_torch.tuning``, ``analysis.perf_features``) and its two
consumers — predicted-cost serving admission and the divergence
watchdog — held against the JAX package on the same records.

Tolerances: the fitted heads' coefficients and predictions within
rtol = 1e-9 (the same numpy least squares on the same float64 matrices;
only summation order could differ); everything else exact.
"""
import math

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.analysis import perf_features as jfeatures
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.observability import events as jevents
from paddle_tpu.observability import watchdog as jwatchdog
from paddle_tpu.observability.__main__ import main as jax_obs_main
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.tuning import learned as jlearned

from paddle_tpu_torch.analysis import perf_features
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.models import (GPTForPretraining, gpt_config,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.observability import watchdog
from paddle_tpu_torch.observability.__main__ import main as obs_main
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.tuning import learned

RTOL = 1e-9
_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _records(seed=0, n=40):
    """A telemetry stream of both event-log families: ``batch_step``
    records of varied composition (a few cold, which neither fit may
    use) and ``step`` records in two runs with their run context."""
    rs = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        b = int(rs.randint(1, 9))
        pre = int(rs.randint(0, b + 1))
        qw = 1 if pre == 0 else int(2 ** rs.randint(3, 10))
        tokens = (b - pre) + pre * qw
        recs.append({"kind": "batch_step", "run": "serve", "batch": b,
                     "prefill_seqs": pre, "decode_seqs": b - pre,
                     "q_width": qw, "tokens": tokens,
                     "queue_depth": int(rs.randint(0, 4)),
                     "page_occupancy": round(float(rs.uniform(0, 1)), 4),
                     "fused_steps": 1,
                     "cold_start": True if i % 13 == 0 else None,
                     "step_s": round(1e-3 * (2 + 0.01 * tokens + b)
                                     * float(rs.uniform(0.9, 1.1)), 6)})
    for run, ops in (("train-a", {"dot_general": 40, "add": 90,
                                  "psum": 4}),
                     ("train-b", {"dot_general": 80, "exp": 30,
                                  "reduce_sum": 12})):
        recs.append({"kind": "dispatch_summary", "run": run, "ops": ops,
                     "host_transfers": 3})
        recs.append({"kind": "graph_pass", "run": run, "removed": 5,
                     "op_class_delta": {"elementwise": -5}})
        for s in range(6):
            recs.append({"kind": "step", "run": run, "step": s,
                         "step_time_s": round(0.05 * (1 + (run[-1] == "b"))
                                              * float(rs.uniform(0.95,
                                                                 1.05)),
                                              6)})
    return recs


def _write(events_mod, setf, d, recs):
    setf({"FLAGS_observability_dir": str(d)})
    try:
        for r in recs:
            r = dict(r)
            kind = r.pop("kind")
            r.pop("run")
            events_mod.emit(kind, **r)
    finally:
        setf({"FLAGS_observability_dir": ""})


def test_event_samples_match_jax():
    recs = _records()
    assert perf_features.event_samples(recs) == \
        jfeatures.event_samples(recs)
    assert perf_features.training_matrix(recs) == \
        jfeatures.training_matrix(recs)


def test_fit_from_telemetry_matches_jax(tmp_path):
    """The same event log fitted by both packages: the same families
    fitted, the same head coefficients and holdout statistics, the same
    predictions."""
    d = tmp_path / "obs"
    _write(obs_events, set_flags, d, _records(seed=1, n=48))
    port, port_sum = learned.fit_from_telemetry(None, [str(d)])
    ref, ref_sum = jlearned.fit_from_telemetry(None, [str(d)])
    assert sorted(port.heads) == sorted(ref.heads) == ["batch_step",
                                                        "step"]
    assert port_sum.keys() == ref_sum.keys()
    for fam in port_sum:
        assert port_sum[fam].keys() == ref_sum[fam].keys(), fam
    ph, rh = port.heads["batch_step"], ref.heads["batch_step"]
    assert ph.feature_names == rh.feature_names
    for key in ("mu", "sd", "w"):
        np.testing.assert_allclose(getattr(ph, key), getattr(rh, key),
                                   rtol=RTOL, atol=0)
    assert ph.b == pytest.approx(rh.b, rel=RTOL)
    assert ph.stats["n_samples"] == rh.stats["n_samples"] == 44
    for key in ("holdout_male", "baseline_male"):
        assert ph.stats[key] == pytest.approx(rh.stats[key], rel=RTOL,
                                              abs=1e-6)
    for feats, _ in perf_features.batch_step_samples(_records(seed=2)):
        assert port.predict("batch_step", feats) == pytest.approx(
            ref.predict("batch_step", feats), rel=RTOL)


def test_step_family_and_round_trip_match_jax(tmp_path):
    """On a shorter log (``min_samples`` 4) both families fit alike; the
    saved model reloads with a bumped version and predicts alike."""
    d = tmp_path / "obs"
    _write(obs_events, set_flags, d, _records(seed=3, n=16))
    port, _ = learned.fit_from_telemetry(None, [str(d)], min_samples=4)
    ref, _ = jlearned.fit_from_telemetry(None, [str(d)], min_samples=4)
    assert sorted(port.heads) == sorted(ref.heads) == ["batch_step",
                                                        "step"]
    feats = perf_features.step_samples(_records(seed=3, n=16))[0][0]
    assert port.predict("step", feats) == pytest.approx(
        ref.predict("step", feats), rel=RTOL)
    cache = tmp_path / "cache"
    learned.save_model(port, str(cache))
    learned.save_model(port, str(cache))
    back = learned.load_model(str(cache))
    assert back.version == 2
    assert back.predict("step", feats) == pytest.approx(
        port.predict("step", feats), rel=1e-12)
    # the JAX package reads the port's file alike
    assert jlearned.load_model(str(cache)).predict("step", feats) == \
        pytest.approx(port.predict("step", feats), rel=1e-12)


def test_sanity_gate_passes():
    assert learned.sanity_check() == [] == jlearned.sanity_check()


# ---------------------------------------------------------------------------
# predicted-cost serving admission (the reference's cases, both packages)
# ---------------------------------------------------------------------------

class _FakeBatchModel:
    version = 1

    def __init__(self, per_token_s=0.01):
        self.per_token_s = per_token_s

    def has(self, family):
        return family == "batch_step"

    def predict(self, family, feats):
        return self.per_token_s * feats["tokens"]


class _Broken:
    def has(self, family):
        return True

    def predict(self, family, feats):
        raise RuntimeError("boom")


ADMISSION = {
    # name: (perf model, budget, requests) — the reference's three cases
    "respects the budget": (_FakeBatchModel(), 0.25, 5),
    "never starves": (_FakeBatchModel(per_token_s=1.0), 0.001, 1),
    "a model error falls back to raw caps": (_Broken(), 0.1, 3),
}


@pytest.mark.parametrize("case", list(ADMISSION))
def test_scheduler_admission_matches_jax(case):
    model, budget, n = ADMISSION[case]
    got = {}
    for name, mod in (("jax", jsched), ("port", tsched)):
        sched = mod.Scheduler(mod.PagePool(64, 4), max_batch=8,
                              max_pages_per_seq=8, perf_model=model,
                              max_step_cost_s=budget)
        for _ in range(n):
            sched.submit(mod.Request([1] * 10, max_new_tokens=2))
        plan, admitted, _ = sched.plan_step()
        got[name] = (plan is not None, len(admitted),
                     [None if s.predicted_cost_s is None
                      else round(s.predicted_cost_s, 9) for s in admitted],
                     sched.deferred_admissions, sched.queue_depth())
    assert got["port"] == got["jax"]
    if case == "respects the budget":
        # 10 tokens -> 0.1 s, 20 -> 0.2 s, 30 -> 0.3 s > budget: 2 admit
        assert got["port"][1:3] == (2, [0.1, 0.2])
        assert got["port"][3] >= 1
    else:
        assert got["port"][1] == n


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
    jm.eval()
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT), device="cpu")
    load_paddle_tpu_state(pm, arrays)
    return jm, pm


def test_engine_admission_emits_predicted_cost_matches_jax(models,
                                                          tmp_path):
    """Both engines price each admission with the model and log it on
    ``serving_admit``; the same requests give the same prices."""
    jm, pm = models
    prompts = [list(range(1, 10)), list(range(20, 25))]
    got = {}
    for name, eng_cls, model, events_mod, setf, kw in (
            ("jax", JaxEngine, jm, jevents, jax_set_flags, {}),
            ("port", ServingEngine, pm, obs_events, set_flags,
             {"device": "cpu"})):
        d = tmp_path / name
        setf({"FLAGS_observability_dir": str(d)})
        try:
            eng = eng_cls(model, max_batch=2, page_size=8,
                          perf_model=_FakeBatchModel(1e-6),
                          max_step_cost_s=10.0, **kw)
            assert eng.scheduler.perf_model is not None
            eng._accepting = True
            reqs = [eng.submit(p, max_new_tokens=3) for p in prompts]
            eng.start()
            toks = [r.wait(timeout=60) for r in reqs]
            eng.stop()
        finally:
            setf({"FLAGS_observability_dir": ""})
        admits = events_mod.read_events(str(d), kinds=["serving_admit"])
        got[name] = (toks, [a["predicted_cost_s"] for a in admits])
    assert got["port"] == got["jax"]
    assert all(c > 0 for c in got["port"][1])


AUTO = {
    # name: (heads saved, max_step_cost_s, a model is used)
    "loaded for a positive budget": (("batch_step",), 0.5, True),
    "not loaded without a budget": (("batch_step",), 0.0, False),
    "unused without a batch_step head": (("step",), 0.5, False),
}


@pytest.mark.parametrize("case", list(AUTO))
def test_auto_perf_model_rule(models, tmp_path, case):
    """``perf_model="auto"`` keeps the reference's rule: it loads
    ``FLAGS_tuning_cache_dir``'s model only for a positive budget, and
    uses only one with a ``batch_step`` head."""
    heads, budget, used = AUTO[case]
    recs = _records(seed=4, n=16)
    d = tmp_path / "obs"
    _write(obs_events, set_flags, d, recs)
    full, _ = learned.fit_from_telemetry(None, [str(d)], min_samples=4)
    model = learned.LearnedPerfModel({h: full.heads[h] for h in heads})
    learned.save_model(model, str(tmp_path / "cache"))
    set_flags({"FLAGS_tuning_cache_dir": str(tmp_path / "cache")})
    try:
        eng = ServingEngine(models[1], max_batch=2, page_size=8,
                            max_step_cost_s=budget, device="cpu")
    finally:
        set_flags({"FLAGS_tuning_cache_dir": ""})
    assert (eng.scheduler.perf_model is not None) == used
    assert eng.scheduler.max_step_cost_s == budget


def test_engine_run_yields_training_matrix(tmp_path):
    """The port engine's event log is a training matrix: every
    ``batch_step`` carries ``step_s`` and ``page_occupancy`` and only
    schema fields; a step shape's first dispatch is marked cold and
    left out of the samples."""
    model = GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT),
                              device="cpu", seed=3)
    rs = np.random.RandomState(5)
    set_flags({"FLAGS_observability_dir": str(tmp_path)})
    try:
        with ServingEngine(model, max_batch=2, page_size=8,
                           device="cpu") as eng:
            reqs = [eng.submit(rs.randint(0, 512, (n,)).tolist(),
                               max_new_tokens=4) for n in (9, 5)]
            for r in reqs:
                r.wait(timeout=60)
    finally:
        set_flags({"FLAGS_observability_dir": ""})
    recs = obs_events.read_events(str(tmp_path))
    steps = [r for r in recs if r["kind"] == "batch_step"]
    for r in steps:
        assert r["step_s"] > 0 and 0.0 <= r["page_occupancy"] <= 1.0
        for field in r:
            assert field in obs_events.EVENT_SCHEMA["batch_step"] \
                or field in obs_events.ENVELOPE_FIELDS
    cold = [r for r in steps if r.get("cold_start")]
    warm = [r for r in steps if not r.get("cold_start")]
    assert cold and warm
    mat = perf_features.training_matrix(recs)
    assert len(mat["batch_step"]["rows"]) == len(warm)
    for row in mat["batch_step"]["rows"]:
        assert all(math.isfinite(v) for v in row)


# ---------------------------------------------------------------------------
# the divergence watchdog and its CLI
# ---------------------------------------------------------------------------

def _batch_step_record(b, scale=1.0):
    return {"kind": "batch_step", "run": "r1", "batch": b,
            "prefill_seqs": 1, "decode_seqs": b - 1, "q_width": 8,
            "tokens": 8 + b, "queue_depth": 0, "page_occupancy": 0.2,
            "step_s": 0.001 * (8 + b) * scale}


def _batch_step_model(mod, version=1):
    samples = []
    for b in range(1, 17):
        feats = {"batch": float(b), "prefill_seqs": 1.0,
                 "decode_seqs": float(b - 1), "q_width": 8.0,
                 "tokens": float(8 + b), "queue_depth": 0.0,
                 "page_occupancy": 0.2}
        samples.append((feats, 0.001 * (8 + b)))
    return mod.LearnedPerfModel(
        {"batch_step": mod._Head.fit("batch_step", samples)},
        version=version)


def test_model_check_clean_then_regressed_matches_jax(tmp_path):
    clean = [_batch_step_record(b) for b in range(1, 9)]
    slow = [_batch_step_record(b, scale=4.0) for b in range(1, 9)]
    port_model = _batch_step_model(learned, version=3)
    ref_model = _batch_step_model(jlearned, version=3)
    assert watchdog.model_check(clean, port_model, emit_events=False) \
        == [] == jwatchdog.model_check(clean, ref_model, emit_events=False)
    set_flags({"FLAGS_observability_dir": str(tmp_path)})
    try:
        findings = watchdog.model_check(slow, port_model)
    finally:
        set_flags({"FLAGS_observability_dir": ""})
    assert findings == jwatchdog.model_check(slow, ref_model,
                                             emit_events=False)
    assert len(findings) == 1 and findings[0]["ratio"] > 3.5
    assert findings[0]["model_version"] == 3
    emitted = obs_events.read_events(str(tmp_path),
                                     kinds=["perf_regression"])
    assert len(emitted) == 1 and emitted[0]["ratio"] == findings[0]["ratio"]
    assert emitted[0]["tolerance"] == watchdog.DEFAULT_TOLERANCE


def test_watchdog_cli_perf_model_exit_codes_match_jax(tmp_path):
    """Exit 3 on divergence, 0 on a clean replay of the same shapes (and
    with ``--warn-only``), 2 without a trained model — from both CLIs,
    over the same logs and the same model file."""
    cache_dir = tmp_path / "cache"
    learned.save_model(_batch_step_model(learned), str(cache_dir))
    clean_dir, slow_dir = tmp_path / "clean", tmp_path / "slow"
    for d, scale in ((clean_dir, 1.0), (slow_dir, 4.0)):
        _write(obs_events, set_flags, d,
               [_batch_step_record(b, scale=scale) for b in range(1, 9)])
    cases = [(clean_dir, cache_dir, [], 0), (slow_dir, cache_dir, [], 3),
             (slow_dir, cache_dir, ["--warn-only"], 0),
             (slow_dir, tmp_path / "empty", [], 2)]
    for log, model_dir, extra, want in cases:
        argv = ["watchdog", "--dir", str(log), "--perf-model",
                str(model_dir), *extra]
        assert obs_main(argv) == want == jax_obs_main(argv), argv
