"""Fault containment of the port's serving engine held against the JAX
engine on the CPU: quarantine bisection, the NaN-logits sentinel, the
prompt-hash rejection, the hung-step watchdog and its relaunch cap,
deadlines (mid-batch and up front) and their HTTP status.

Each scenario runs on both engines under the same ``FLAGS_fault_schedule``
(each package its own injector, flags and event log), over the ``tiny``
GPT preset with the JAX weights carried into the port.  Every request is
queued before the loop starts, so the first step admits all of them and
both engines plan the same steps and pin the sticky poison to the same
request.  Compared: tokens (IDENTICAL: greedy, fp32), ``error_kind``s,
the order of the health states, the ``stats()`` counters and the event
kinds and counts.  The innocents' tokens also equal a clean run of the
port's engine.  Timeouts are the JAX chaos tests' (0.3-0.5 s), and every
scenario runs under ``FLAGS_lock_sanitizer`` in both packages.

Port-only: the zombie fence (a thread of an abandoned epoch draws nothing
from the generator) and the sticky-device-error path (the probe stubbed).
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.inference.serving import InferenceServer as JaxServer
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.observability import events as jax_events
from paddle_tpu.observability.lockwatch import \
    reset_lockwatch as jax_reset_lockwatch
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.flags import get_flags, set_flags
from paddle_tpu_torch.inference.serving import InferenceServer
from paddle_tpu_torch.models import (GPTForPretraining, gpt_config,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.observability.lockwatch import reset_lockwatch
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import ServingEngine

WAIT = 120.0
VOCAB = 512
_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
# the stats() counters and the event kinds both engines must agree on
STATS = ("health", "quarantined", "quarantined_prompts", "cancelled",
         "watchdog_relaunches", "wedged_threads", "evictions",
         "deferred_admissions")
EVENTS = ("quarantine", "health_transition", "step_timeout",
          "request_cancelled", "fault", "serving_admit", "batch_step")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
    jm.eval()
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT), device="cpu")
    load_paddle_tpu_state(pm, arrays)
    return jm, pm


class Side:
    """One package's engine class, model, flags, injector and event log."""

    def __init__(self, name, engine_cls, model, set_flags_fn, faults_mod,
                 events_mod, log_dir, **engine_kw):
        self.name = name
        self.engine_cls = engine_cls
        self.model = model
        self.set_flags = set_flags_fn
        self.faults = faults_mod
        self.events = events_mod
        self.dir = log_dir
        self.engine_kw = engine_kw

    def engine(self, **kw):
        return self.engine_cls(self.model, **kw, **self.engine_kw)

    def records(self, kind=None):
        return self.events.read_events(
            self.dir, kinds=None if kind is None else [kind])

    def outcome(self, engine, reqs, counted=EVENTS):
        """Every request waited for, then what both engines must agree
        on."""
        tokens = _run_all(reqs)
        # a request finishes inside the step's commit block, whose events
        # are written before the engine lock is released
        with engine._lock:
            pass
        st = engine.stats()
        recs = self.records()
        return dict(
            tokens=tokens, error_kinds=[r.error_kind for r in reqs],
            health=[e["state"] for e in recs
                    if e["kind"] == "health_transition"],
            stats={k: st[k] for k in STATS},
            events={k: sum(1 for e in recs if e["kind"] == k)
                    for k in counted})


@pytest.fixture
def sides(models, tmp_path):
    """Both packages with their own event log, the lock sanitizer on, and
    guaranteed fault-schedule and flag cleanup (a leaked schedule would
    poison every test that follows)."""
    jm, pm = models
    out = {}
    for name, setf, reset in (("jax", jax_set_flags, jax_reset_lockwatch),
                              ("port", set_flags, reset_lockwatch)):
        d = tmp_path / name
        d.mkdir()
        setf({"FLAGS_observability_dir": str(d),
              "FLAGS_lock_sanitizer": True})
        reset()
    out["jax"] = Side("jax", JaxEngine, jm, jax_set_flags, jax_faults,
                      jax_events, str(tmp_path / "jax"))
    out["port"] = Side("port", ServingEngine, pm, set_flags, faults,
                       obs_events, str(tmp_path / "port"), device="cpu")
    try:
        yield out
    finally:
        for name, setf, reset in (
                ("jax", jax_set_flags, jax_reset_lockwatch),
                ("port", set_flags, reset_lockwatch)):
            out[name].faults.install_schedule(None)
            setf({"FLAGS_observability_dir": "",
                  "FLAGS_serving_step_timeout_s": 0.0,
                  "FLAGS_lock_sanitizer": False})
            reset()


def _run_all(reqs, timeout=WAIT):
    """wait() every request; None in the slot of each failed stream."""
    out = []
    for r in reqs:
        try:
            out.append(r.wait(timeout=timeout))
        except (RuntimeError, TimeoutError):
            out.append(None)
    return out


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (n,)).tolist() for n in lengths]


def _queue_then_start(engine, prompts, **kw):
    """Queue every request, then start the loop: its first plan admits
    them all."""
    engine._accepting = True
    reqs = [engine.submit(p, **kw) for p in prompts]
    engine.start()
    return reqs


def _oracle(models, prompts, n_new, max_batch):
    """The port engine's clean run of the same requests (outside the
    scenario's event log)."""
    _, pm = models
    log = get_flags(["FLAGS_observability_dir"])
    set_flags({"FLAGS_observability_dir": ""})
    eng = ServingEngine(pm, max_batch=max_batch, page_size=8, device="cpu")
    try:
        return _run_all(_queue_then_start(eng, prompts,
                                          max_new_tokens=n_new))
    finally:
        eng.stop()
        set_flags(log)


def _both(sides, schedule, run, flags=None):
    """``run(side)`` on each package under ``schedule``; returns
    {name: run's result}."""
    got = {}
    for name, side in sides.items():
        side.faults.install_schedule(schedule)
        if flags:
            side.set_flags(flags)
        got[name] = run(side)
        side.faults.install_schedule(None)
    return got


@pytest.mark.chaos
def test_quarantine_bisection_matches_jax(models, sides):
    """``serving_step@3=exc`` pins sticky poison to one of 8 co-batched
    streams: on both engines the same request alone fails as
    quarantined, the 7 innocents finish with the clean run's tokens, and
    health walks ok -> quarantining -> degraded."""
    prompts = _prompts(11, (4, 6, 8, 5, 7, 9, 3, 10))
    want = _oracle(models, prompts, 8, 8)

    def run(side):
        eng = side.engine(max_batch=8, page_size=8)
        try:
            return side.outcome(eng, _queue_then_start(
                eng, prompts, max_new_tokens=8))
        finally:
            eng.stop(drain=False)

    got = _both(sides, "serving_step@3=exc", run)
    assert got["port"] == got["jax"]
    port = got["port"]
    bad = [i for i, t in enumerate(port["tokens"]) if t is None]
    assert len(bad) == 1 and port["error_kinds"][bad[0]] == "quarantined"
    assert [t for i, t in enumerate(port["tokens"]) if i != bad[0]] == \
        [t for i, t in enumerate(want) if i != bad[0]]
    assert port["stats"]["quarantined"] == 1
    assert port["stats"]["quarantined_prompts"] == 1
    assert port["health"] == ["quarantining", "degraded"]
    mine = [e for e in sides["port"].records("quarantine")
            if e["action"] == "quarantined"]
    assert len(mine) == 1


@pytest.mark.chaos
def test_quarantined_prompt_rejected_at_admission_matches_jax(models,
                                                              sides):
    """The prompt that poisoned a batch is rejected at admission by its
    hash when resubmitted; the engine keeps serving other work."""
    poison, clean = _prompts(12, (6, 5))
    [want_clean] = _oracle(models, [clean], 6, 2)

    def run(side):
        eng = side.engine(max_batch=2, page_size=8).start()
        try:
            first = eng.submit(poison, max_new_tokens=6)
            _run_all([first])
            again = eng.submit(poison, max_new_tokens=6)
            _run_all([again])
            later = eng.submit(clean, max_new_tokens=6)
            out = side.outcome(eng, [first, again, later])
            out["errors"] = [r.error.split(":")[0] if r.error else None
                             for r in (first, again, later)]
            out["actions"] = [e["action"] for e in
                              side.records("quarantine")]
            return out
        finally:
            eng.stop(drain=False)

    got = _both(sides, "serving_step@1=exc", run)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["tokens"] == [None, None, want_clean]
    assert port["error_kinds"] == ["quarantined", "quarantined", None]
    assert port["actions"] == ["quarantined", "rejected"]
    assert port["stats"]["quarantined_prompts"] == 1


@pytest.mark.chaos
def test_nan_sentinel_quarantines_offending_lane_matches_jax(models, sides):
    """``serving_step@2=nan``: the lane whose logits go NaN samples -1 on
    the device and is quarantined alone; the others are untouched."""
    prompts = _prompts(13, (4, 6, 8, 5))
    want = _oracle(models, prompts, 8, 4)

    def run(side):
        eng = side.engine(max_batch=4, page_size=8)
        try:
            out = side.outcome(eng, _queue_then_start(
                eng, prompts, max_new_tokens=8))
            out["reasons"] = [e["reason"] for e in
                              side.records("quarantine")]
            return out
        finally:
            eng.stop(drain=False)

    got = _both(sides, "serving_step@2=nan", run)
    assert got["port"] == got["jax"]
    port = got["port"]
    bad = [i for i, t in enumerate(port["tokens"]) if t is None]
    assert len(bad) == 1 and port["error_kinds"][bad[0]] == "quarantined"
    assert port["reasons"] == ["nan_logits"]
    assert [t for i, t in enumerate(port["tokens"]) if i != bad[0]] == \
        [t for i, t in enumerate(want) if i != bad[0]]


@pytest.mark.chaos
def test_watchdog_relaunch_keeps_all_streams_exact_matches_jax(models,
                                                               sides):
    """A stalled dispatch trips the 0.5 s watchdog: the loop relaunches
    once, every stream is requeued at the front and finishes with the
    clean run's tokens, on both engines alike."""
    prompts = _prompts(14, (4, 6, 8, 5))
    want = _oracle(models, prompts, 8, 4)

    def run(side):
        eng = side.engine(max_batch=4, page_size=8)
        try:
            reqs = _queue_then_start(eng, prompts, max_new_tokens=8)
            out = side.outcome(eng, reqs)
            out["evictions"] = [r.evictions for r in reqs]
            out["timeouts"] = [(e["relaunches"], e["timeout_s"])
                               for e in side.records("step_timeout")]
            return out
        finally:
            eng.stop(drain=False)

    got = _both(sides, "serving_step@4=stall:2", run,
                flags={"FLAGS_serving_step_timeout_s": 0.5})
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["tokens"] == want
    assert port["stats"]["watchdog_relaunches"] == 1
    assert port["health"] == ["degraded"]
    assert port["timeouts"] == [(1, 0.5)]
    assert all(n >= 1 for n in port["evictions"])


@pytest.mark.chaos
def test_watchdog_relaunch_cap_fails_engine_matches_jax(sides):
    """Past the relaunch cap (0) both engines go failed: every consumer
    fails as unhealthy and a late submit is rejected."""
    def run(side):
        eng = side.engine(max_batch=2, page_size=8,
                          max_watchdog_relaunches=0)
        try:
            reqs = _queue_then_start(eng, [[1, 2, 3], [4, 5, 6]],
                                     max_new_tokens=8)
            out = side.outcome(eng, reqs)
            late = eng.submit([7, 8], max_new_tokens=2)
            out["late"] = (_run_all([late]), late.error_kind)
            return out
        finally:
            eng.stop(drain=False)

    got = _both(sides, "serving_step@2=stall:2", run,
                flags={"FLAGS_serving_step_timeout_s": 0.3})
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["tokens"] == [None, None]
    assert port["error_kinds"] == ["unhealthy", "unhealthy"]
    assert port["health"] == ["failed"]
    assert port["late"] == ([None], "unhealthy")


@pytest.mark.chaos
def test_deadline_cancels_mid_batch_and_frees_pages_matches_jax(models,
                                                                sides):
    """A request whose deadline passes while it decodes is cancelled
    from inside the loop (error_kind "deadline", a request_cancelled
    event); the co-batched request is untouched and every page comes
    back."""
    p_ok, p_doomed = _prompts(15, (5, 5))
    [want_ok] = _oracle(models, [p_ok], 8, 2)

    def run(side):
        eng = side.engine(max_batch=2, page_size=8, prefix_caching=False)
        free0 = eng.pool.available()
        try:
            eng._accepting = True
            doomed = eng.submit(p_doomed, max_new_tokens=120,
                                deadline_s=0.3)
            ok = eng.submit(p_ok, max_new_tokens=8)
            eng.start()
            out = side.outcome(eng, [ok, doomed],
                               counted=("quarantine", "health_transition",
                                        "request_cancelled"))
            deadline = time.monotonic() + 10
            while eng.pool.available() != free0 and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            out["free_pages_back"] = eng.pool.available() == free0
            out["cancel"] = [(e["request"] == doomed.id,
                              "deadline" in e["reason"], e["deadline_s"])
                             for e in side.records("request_cancelled")]
            return out
        finally:
            eng.stop(drain=False)

    got = _both(sides, None, run)
    for g in got.values():          # how far the doomed one got is timing
        g["tokens"][1] = None
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["tokens"] == [want_ok, None]
    assert port["error_kinds"] == [None, "deadline"]
    assert port["free_pages_back"]
    assert port["cancel"] == [(True, True, 0.3)]
    assert port["stats"]["cancelled"] == 1


class _StubPerfModel:
    """Every batch step predicted to take ``step_s`` seconds."""

    def __init__(self, step_s):
        self.step_s = step_s

    def has(self, head):
        return True

    def predict(self, head, feats):
        return self.step_s


def test_deadline_doomed_rejected_up_front_matches_jax(sides):
    """Predicted-cost admission: a request whose full decode cannot fit
    its deadline is rejected at submit; without a deadline the same
    request is served."""
    def run(side):
        eng = side.engine(max_batch=2, page_size=8,
                          perf_model=_StubPerfModel(10.0)).start()
        try:
            doomed = eng.submit([1, 2, 3], max_new_tokens=8, deadline_s=0.5)
            served = eng.submit([1, 2, 3], max_new_tokens=4)
            out = side.outcome(eng, [doomed, served])
            out["infeasible"] = "deadline infeasible" in doomed.error
            return out
        finally:
            eng.stop(drain=False)

    got = _both(sides, None, run)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["error_kinds"] == ["deadline", None]
    assert port["tokens"][0] is None and len(port["tokens"][1]) == 4
    assert port["infeasible"]


def test_http_deadline_maps_to_503_matches_jax(sides):
    """``deadline_s`` rides the /generate spec: a doomed deadline answers
    503 + Retry-After from both servers."""
    def run(side):
        side.set_flags({"FLAGS_serving_engine": True})
        eng = side.engine(max_batch=2, page_size=8,
                          perf_model=_StubPerfModel(10.0)).start()
        srv = (InferenceServer if side.name == "port" else JaxServer)(
            engine=eng, max_in_flight=8).start()
        try:
            body = json.dumps({"input_ids": [1, 2, 3], "max_new_tokens": 8,
                               "deadline_s": 0.25}).encode()
            req = urllib.request.Request(srv.url + "/generate", data=body,
                                         method="POST")
            try:
                urllib.request.urlopen(req, timeout=30)
                return None
            except urllib.error.HTTPError as e:
                return e.code, e.headers.get("Retry-After") is not None
        finally:
            srv.stop()
            eng.stop(drain=False)
            side.set_flags({"FLAGS_serving_engine": False})

    got = _both(sides, None, run)
    assert got == {"jax": (503, True), "port": (503, True)}


# ---------------------------------------------------------------------------
# port-only: the zombie fence and the sticky device error
# ---------------------------------------------------------------------------

def _sampled_after_relaunch(pm, stall_s):
    """One sampled request across a relaunch (the loop stalls
    ``stall_s`` at its 4th dispatch; the watchdog fires at 0.3 s), then,
    once the abandoned thread has either exited or is still asleep, a
    second sampled request.  Returns (both requests' tokens, the
    generator's state, whether the abandoned thread is alive)."""
    faults.install_schedule(f"serving_step@4=stall:{stall_s}")
    set_flags({"FLAGS_serving_step_timeout_s": 0.3})
    eng = ServingEngine(pm, max_batch=2, page_size=8, seed=5, device="cpu")
    try:
        eng.start()
        first = eng.submit([3, 1, 4, 1, 5], max_new_tokens=8,
                           temperature=0.9).wait(timeout=WAIT)
        assert eng.stats()["watchdog_relaunches"] == 1
        [(zombie, _, _)] = eng._abandoned
        if stall_s < 5:
            zombie.join(timeout=WAIT)        # it woke and returned
        alive = zombie.is_alive()
        second = eng.submit([2, 7, 1, 8], max_new_tokens=8,
                            temperature=0.9).wait(timeout=WAIT)
        state = eng._gen.get_state()
    finally:
        eng.stop(drain=False)
        faults.install_schedule(None)
        set_flags({"FLAGS_serving_step_timeout_s": 0.0})
    return (first, second), state, alive


@pytest.mark.chaos
def test_zombie_draws_nothing_after_a_relaunch(models):
    """A thread of an abandoned epoch that wakes after the relaunch
    launches and draws nothing: the generator and both sampled streams
    equal a run in which it never woke."""
    _, pm = models
    woke, state_woke, alive_woke = _sampled_after_relaunch(pm, 1.0)
    slept, state_slept, alive_slept = _sampled_after_relaunch(pm, 30.0)
    assert not alive_woke and alive_slept
    assert woke == slept
    assert torch.equal(state_woke, state_slept)


@pytest.mark.chaos
def test_sticky_device_error_fails_the_engine(models, tmp_path):
    """A failed step after which the device no longer runs work (the
    probe stubbed to fail, as after an illegal address) fails the engine
    instead of bisecting: health failed, nothing quarantined, every
    request unhealthy and a late submit rejected."""
    _, pm = models
    set_flags({"FLAGS_observability_dir": str(tmp_path)})
    faults.install_schedule("serving_step@2=exc")
    eng = ServingEngine(pm, max_batch=4, page_size=8, device="cpu")
    eng._device_ok = lambda: False
    try:
        reqs = _queue_then_start(eng, _prompts(16, (4, 6, 5)),
                                 max_new_tokens=8)
        assert _run_all(reqs) == [None, None, None]
        late = eng.submit([1, 2], max_new_tokens=2)
        assert _run_all([late]) == [None]
        st = eng.stats()
    finally:
        eng.stop(drain=False)
        faults.install_schedule(None)
        set_flags({"FLAGS_observability_dir": ""})
    assert [r.error_kind for r in reqs + [late]] == ["unhealthy"] * 4
    assert st["health"] == "failed" and st["quarantined"] == 0
    assert st["failed_steps"] == 1
    states = [e["state"] for e in obs_events.read_events(
        str(tmp_path), kinds=["health_transition"])]
    assert states == ["failed"]
    assert not obs_events.read_events(str(tmp_path), kinds=["quarantine"])
