"""The observability modules copied into the port
(``paddle_tpu_torch.observability``: metrics, events, tracing,
lockwatch, the SLO watchdog and the ``python -m`` CLI) and
``resilience.retry`` / ``resilience.faults``, held to cases of the JAX
package's own tests (``tests/test_observability.py``,
``tests/test_tracing.py``, ``tests/test_lockwatch.py``), run against the
copies; the copies' public surface against the reference's (signatures,
the event schema); and both CLIs over one event log of the port's
engine, which must print the same output.
"""
import inspect
import json
import os
import threading
import time

import pytest

from paddle_tpu.observability import events as jevents
from paddle_tpu.observability import lockwatch as jlockwatch
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.observability import watchdog as jwatchdog
from paddle_tpu.observability.__main__ import main as jax_obs_main
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import retry as jretry

from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.observability import events, lockwatch, metrics
from paddle_tpu_torch.observability import tracing, watchdog
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.observability.__main__ import main as obs_main
from paddle_tpu_torch.observability.lockwatch import (
    LockOrderError, make_condition, make_lock, make_rlock,
    reset_lockwatch)
from paddle_tpu_torch.observability.metrics import (HistogramValue,
                                                    MetricsRegistry)
from paddle_tpu_torch.resilience import faults, retry


@pytest.fixture
def obs_dir(tmp_path):
    d = str(tmp_path / "obs")
    set_flags({"FLAGS_observability_dir": d})
    try:
        yield d
    finally:
        set_flags({"FLAGS_observability_dir": ""})


@pytest.fixture
def sanitizer_on():
    set_flags({"FLAGS_lock_sanitizer": True})
    reset_lockwatch()
    try:
        yield
    finally:
        set_flags({"FLAGS_lock_sanitizer": False})
        reset_lockwatch()


# ---------------------------------------------------------------------------
# the copies' surface against the reference's
# ---------------------------------------------------------------------------

SURFACE = {
    "metrics": (jmetrics, metrics, ["counter", "gauge", "histogram",
                                    "default_registry", "set_enabled"]),
    "events": (jevents, events, ["configure", "enabled", "emit",
                                 "read_events", "log_dir"]),
    "tracing": (jtracing, tracing, ["start_span", "parse_traceparent",
                                    "format_traceparent",
                                    "flight_snapshot", "dump_flight",
                                    "set_flight_capacity", "build_trace",
                                    "render_trace"]),
    "lockwatch": (jlockwatch, lockwatch, ["make_lock", "make_rlock",
                                          "make_condition",
                                          "reset_lockwatch"]),
    "retry": (jretry, retry, ["with_retries", "deterministic_jitter"]),
    "watchdog": (jwatchdog, watchdog, ["duration_key", "collect_durations",
                                       "summarize", "compute_baselines",
                                       "check", "self_check",
                                       "model_check"]),
    "faults": (jfaults, faults, ["parse_schedule", "install_schedule",
                                 "get_injector", "maybe_fault",
                                 "queue_serving_poison",
                                 "take_serving_poison",
                                 "queue_collective_damage",
                                 "take_collective_damage"]),
}


@pytest.mark.parametrize("module", list(SURFACE))
def test_copied_functions_take_the_reference_signatures(module):
    ref, port, names = SURFACE[module]
    for name in names:
        assert inspect.signature(getattr(port, name)) == \
            inspect.signature(getattr(ref, name)), name


def test_event_schema_is_the_reference_schema():
    assert events.EVENT_SCHEMA == jevents.EVENT_SCHEMA
    assert events.ENVELOPE_FIELDS == jevents.ENVELOPE_FIELDS


def _flaky(fails):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise ConnectionResetError("reset")
        return "ok"
    return fn


def test_retry_backs_off_as_the_reference_and_honours_the_filter():
    got, want = [], []
    assert retry.with_retries(_flaky(2), attempts=4, retry_on=OSError,
                              label="x", sleep=got.append) == "ok"
    jretry.with_retries(_flaky(2), attempts=4, retry_on=OSError,
                        label="x", sleep=want.append)
    assert got == want and len(got) == 2 and got[1] > got[0]
    with pytest.raises(ConnectionResetError):
        retry.with_retries(_flaky(5), attempts=3, retry_on=OSError,
                           sleep=lambda d: None)
    with pytest.raises(KeyError):              # not retried
        retry.with_retries(lambda: {}["k"], attempts=3, retry_on=OSError)
    assert retry.with_retries(_flaky(1), attempts=2, retry_on=OSError,
                              sleep=got.append,
                              delay_from=lambda e: 0.25) == "ok"
    assert got[-1] == 0.25                     # the server's word
    with pytest.raises(ValueError):
        retry.with_retries(lambda: 1, attempts=0)


# ---------------------------------------------------------------------------
# metrics registry (tests/test_observability.py)
# ---------------------------------------------------------------------------


def test_counter_concurrency_exact_total():
    reg = MetricsRegistry()
    c = reg.counter("hammered_total", labels=("who",))
    h = reg.histogram("hammered_seconds", buckets=(0.5, 1.0))
    n_threads, per_thread = 8, 5000

    def work(i):
        child = c.labels(who=str(i % 2))
        for _ in range(per_thread):
            child.inc()
            h.observe(0.25)

    ts = [threading.Thread(target=work, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    total = sum(child.value for _, child in c.series())
    assert total == n_threads * per_thread
    hv = h.child().hist
    assert hv.count == n_threads * per_thread
    assert hv.bucket_counts[0] == n_threads * per_thread  # all <= 0.5
    assert abs(hv.sum - 0.25 * hv.count) < 1e-6


def test_registry_type_and_conflict_rules():
    reg = MetricsRegistry()
    c = reg.counter("x_total", "help")
    assert reg.counter("x_total") is c          # re-register: same family
    with pytest.raises(ValueError):
        reg.gauge("x_total")                    # kind conflict
    with pytest.raises(ValueError):
        reg.counter("x_total", labels=("a",))   # label conflict
    with pytest.raises(ValueError):
        c.labels(bogus="1")                     # undeclared label
    with pytest.raises(ValueError):
        c.child().inc(-1)                       # counters only go up
    g = reg.gauge("g")
    g.set(5)
    g.dec(2)
    assert g.value == 3
    with pytest.raises(ValueError):
        reg.counter("0bad name")


def test_prometheus_text_golden():
    reg = MetricsRegistry()
    reg.counter("req_total", "requests", labels=("code",)) \
        .labels(code="200").inc(3)
    reg.gauge("inflight", "live").set(2)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(9.0)
    want = """\
# HELP inflight live
# TYPE inflight gauge
inflight 2
# HELP lat_seconds latency
# TYPE lat_seconds histogram
lat_seconds_bucket{le="0.1"} 1
lat_seconds_bucket{le="1"} 2
lat_seconds_bucket{le="+Inf"} 3
lat_seconds_sum 9.55
lat_seconds_count 3
# HELP req_total requests
# TYPE req_total counter
req_total{code="200"} 3
"""
    assert reg.prometheus_text() == want


def test_snapshot_json_round_trips():
    reg = MetricsRegistry()
    reg.counter("a_total").inc(7)
    reg.histogram("h_seconds", buckets=(1.0,)).observe(0.5)
    snap = json.loads(json.dumps(reg.snapshot()))
    assert snap["a_total"]["type"] == "counter"
    assert snap["a_total"]["series"][0]["value"] == 7
    assert snap["h_seconds"]["series"][0]["count"] == 1


def test_disabled_metrics_are_noop():
    reg = MetricsRegistry()
    c = reg.counter("kill_total")
    h = reg.histogram("kill_seconds", buckets=(1.0,))
    metrics.set_enabled(False)
    try:
        c.inc()
        h.observe(0.5)
    finally:
        metrics.set_enabled(True)
    assert c.value == 0 and h.child().hist.count == 0
    c.inc()
    assert c.value == 1


def test_histogram_value_quantiles():
    h = HistogramValue(buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 1.5, 3.0):
        h.observe(v)
    assert h.count == 4 and h.avg == pytest.approx(1.625)
    assert 0.0 < h.quantile(0.5) <= 2.0
    s = h.summary()
    assert s["count"] == 4 and s["p99"] <= 4.0


# ---------------------------------------------------------------------------
# event log (tests/test_observability.py)
# ---------------------------------------------------------------------------


def test_event_log_write_read_and_envelope(obs_dir):
    assert events.enabled()
    events.emit("step", step=3, loss=0.5, skipme=None)
    recs = events.read_events(obs_dir)
    assert len(recs) == 1
    r = recs[0]
    assert r["kind"] == "step" and r["step"] == 3 and r["loss"] == 0.5
    assert "skipme" not in r                    # None fields dropped
    for k in ("v", "ts", "pid", "run"):
        assert k in r
    # disabled -> emit is a no-op
    set_flags({"FLAGS_observability_dir": ""})
    events.emit("step", step=4)
    assert len(events.read_events(obs_dir)) == 1


def test_event_log_rotation_and_merge(tmp_path):
    log = events.EventLog(str(tmp_path), rotate_bytes=400,
                          keep_rotated=3)
    for i in range(40):
        log.write("step", {"step": i})
    files = log.files_oldest_first()
    assert len(files) > 1                       # rotation happened
    assert os.path.basename(files[-1]) == "events.jsonl"
    recs = events.read_events(str(tmp_path))
    steps = [r["step"] for r in recs]
    # oldest rotations may be dropped (bounded count) but order holds
    # and the tail is intact
    assert steps == sorted(steps)
    assert steps[-1] == 39


def test_event_log_corrupt_tail_tolerated(tmp_path):
    log = events.EventLog(str(tmp_path))
    log.write("step", {"step": 0})
    log.write("step", {"step": 1})
    with open(log.path, "a", encoding="utf-8") as fh:
        fh.write('{"v": 1, "kind": "step", "step": 2')   # torn tail
    with open(log.path, "ab") as fh:
        fh.write(b"\n\x00\xff garbage\n")
    recs = events.read_events(str(tmp_path))
    assert [r["step"] for r in recs] == [0, 1]


def test_span_emits_duration_and_correlation_id(obs_dir):
    with events.span("ckpt_save", path="/x") as sp:
        pass
    (rec,) = events.read_events(obs_dir, kinds=["ckpt_save"])
    assert rec["span_id"] == sp.span_id
    assert rec["dur_s"] >= 0.0 and rec["path"] == "/x"


# ---------------------------------------------------------------------------
# tracing (tests/test_tracing.py)
# ---------------------------------------------------------------------------


def test_traceparent_roundtrip():
    tid, sid = tracing.new_trace_id(), tracing.new_span_id()
    assert len(tid) == 32 and len(sid) == 16
    ctx = tracing.parse_traceparent(tracing.format_traceparent(tid, sid))
    assert ctx == tracing.TraceContext(tid, sid)


@pytest.mark.parametrize("header", [
    None, "", "garbage", "00-abc-def-01",
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",      # all-zero trace
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",     # all-zero span
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",     # invalid version
    "zz-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
])
def test_traceparent_rejects_malformed(header):
    assert tracing.parse_traceparent(header) is None


def test_span_tree_and_ambient_stamping(obs_dir):
    """Nested spans share the trace; events emitted inside a
    trace_span block inherit its trace_id/span envelope fields."""
    with tracing.trace_span("outer", attrs={"k": 1}) as outer:
        events.emit("serving", action="start", url="u")
        inner = tracing.start_span("inner")
        inner.end(n=2)
    recs = events.read_events(obs_dir)
    spans = {r["name"]: r for r in recs if r["kind"] == "trace_span"}
    assert spans["inner"]["parent"] == spans["outer"]["span"]
    assert spans["inner"]["trace_id"] == spans["outer"]["trace_id"]
    assert spans["outer"]["trace_id"] == outer.trace_id
    assert "parent" not in spans["outer"]           # a trace root
    assert spans["outer"]["status"] == "ok"
    assert spans["outer"]["dur_s"] >= 0
    assert spans["inner"]["attrs"] == {"n": 2}
    ev = next(r for r in recs if r["kind"] == "serving")
    assert ev["trace_id"] == outer.trace_id
    assert ev["span"] == outer.span_id


def test_span_error_status_and_idempotent_end(obs_dir):
    with pytest.raises(ValueError):
        with tracing.trace_span("boom"):
            raise ValueError("x")
    sp = tracing.start_span("twice")
    sp.end()
    sp.end(status="error")                          # no second record
    recs = [r for r in events.read_events(obs_dir)
            if r["kind"] == "trace_span"]
    assert [r["status"] for r in recs
            if r["name"] == "boom"] == ["error"]
    assert len([r for r in recs if r["name"] == "twice"]) == 1


def test_disabled_tracing_is_noop():
    assert not events.enabled()
    sp = tracing.start_span("x")
    assert sp is tracing.NOOP_SPAN
    sp.end()                                        # must not raise
    with tracing.trace_span("y") as sp2:
        assert sp2 is tracing.NOOP_SPAN
        assert tracing.current() is None


def test_build_trace_attaches_links_and_events(obs_dir):
    with tracing.trace_span("serving_request") as root:
        events.emit("serving", action="start", url="u")
    with tracing.trace_span(
            "batch_step",
            links=[{"trace_id": root.trace_id, "span": root.span_id}]):
        pass
    recs = events.read_events(obs_dir)
    tree = tracing.build_trace(recs, root.trace_id)
    assert len(tree["roots"]) == 1
    node = tree["roots"][0]
    assert node["span"]["name"] == "serving_request"
    assert [e["kind"] for e in node["events"]] == ["serving"]
    assert [s["name"] for s in tree["linked"]] == ["batch_step"]
    text = tracing.render_trace(recs, root.trace_id)
    assert "serving_request" in text and "batch_step" in text


def test_flight_ring_bounded_and_dump(obs_dir):
    tracing.set_flight_capacity(8)
    try:
        for i in range(20):
            events.emit("serving", action="start", url=f"u{i}")
        snap = tracing.flight_snapshot()
        assert snap["count"] == 8 and snap["capacity"] == 8
        assert snap["events"][-1]["url"] == "u19"   # newest last
        path = tracing.dump_flight("test-reason")
        assert os.path.basename(path) == f"flight-{os.getpid()}.json"
        with open(path) as fh:
            dump = json.load(fh)
        assert dump["reason"] == "test-reason"
        assert dump["pid"] == os.getpid()
        assert len(dump["events"]) == 8
    finally:
        tracing.set_flight_capacity(512)


def test_flight_dump_disabled_returns_none():
    assert not events.enabled()
    assert tracing.dump_flight("x") is None


# ---------------------------------------------------------------------------
# the lock sanitizer (tests/test_lockwatch.py)
# ---------------------------------------------------------------------------


def test_flag_gates_instrumentation():
    set_flags({"FLAGS_lock_sanitizer": False})
    lock = make_lock("gate.lock")
    assert type(lock) is type(threading.Lock())
    rlock = make_rlock("gate.rlock")
    assert type(rlock) is type(threading.RLock())
    cond = make_condition("gate.cond")
    assert isinstance(cond, threading.Condition)
    # stdlib condition wraps a stdlib RLock, not a watched one
    assert not isinstance(cond._lock, lockwatch._WatchedLock)


def test_planted_inversion_raises_instead_of_hanging(sanitizer_on):
    """The headline contract: the B->A acquire that would deadlock
    against an established A->B order raises a diagnostic naming both
    threads' hold stacks — no interleaving luck required, no hang."""
    A = make_lock("inv.A")
    B = make_lock("inv.B")

    def establish():
        with A:
            with B:
                pass

    t = threading.Thread(target=establish, name="establisher")
    t.start()
    t.join()

    with pytest.raises(LockOrderError) as ei:
        with B:
            with A:          # closes the cycle: raises BEFORE blocking
                pass
    err = ei.value
    assert err.lock == "inv.A"
    assert err.other_thread == "establisher"
    assert "inv.A" in err.path and "inv.B" in err.path
    # both hold stacks are rendered with acquire sites
    msg = str(err)
    assert "establisher" in msg
    assert "inv.B (acquired at" in msg
    assert "inv.A (acquired at" in msg
    # ...and the failing thread did NOT end up owning A
    assert not A.locked()
    assert not B.locked()


def test_same_thread_nesting_one_order_is_fine(sanitizer_on):
    A = make_lock("ok.A")
    B = make_lock("ok.B")
    for _ in range(3):
        with A:
            with B:
                pass
    # same-name re-entry across instances must not self-deadlock
    A2 = make_lock("ok.A")
    with A:
        with A2:
            pass


def test_rlock_reentrancy(sanitizer_on):
    R = make_rlock("re.R")
    with R:
        with R:
            assert R._is_owned()
    assert not R._is_owned()


def test_condition_wait_keeps_graph_honest(sanitizer_on):
    """wait() releases through the wrapper: while the waiter sleeps,
    its held-stack must not pin the condition's lock, or the notifier
    taking an unrelated lock first would false-positive."""
    L = make_lock("cv.L")
    cv = make_condition("cv.C", L)
    other = make_lock("cv.other")
    state = {"go": False, "err": None}

    def waiter():
        try:
            with cv:
                while not state["go"]:
                    cv.wait(timeout=5)
        except BaseException as e:   # pragma: no cover - diagnostic
            state["err"] = e

    t = threading.Thread(target=waiter, name="waiter")
    t.start()
    time.sleep(0.05)
    with other:
        with cv:                     # other -> L order, while waiter sleeps
            state["go"] = True
            cv.notify_all()
    t.join(5)
    assert not t.is_alive()
    assert state["err"] is None


def test_contention_events_and_metrics(tmp_path, sanitizer_on,
                                       monkeypatch):
    monkeypatch.setattr(lockwatch, "WAIT_THRESHOLD_S", 0.0)
    monkeypatch.setattr(lockwatch, "HOLD_THRESHOLD_S", 0.0)
    set_flags({"FLAGS_observability_dir": str(tmp_path)})
    try:
        L = make_lock("contend.L")
        with L:
            time.sleep(0.01)
    finally:
        set_flags({"FLAGS_observability_dir": ""})
    evs = obs_events.read_events(str(tmp_path),
                                 kinds=["lock_contention"])
    phases = {e["phase"] for e in evs}
    assert "wait" in phases and "hold" in phases
    hold = next(e for e in evs if e["phase"] == "hold")
    assert hold["lock"] == "contend.L"
    assert hold["held_s"] >= 0.01
    assert hold["thread"]
    assert ":" in hold["site"]       # file:line of the acquire
    # metric families recorded the acquisition
    reg = metrics.default_registry()
    fam = reg.get("paddle_lock_acquisitions_total")
    assert fam is not None
    assert fam.labels(lock="contend.L").value >= 1
    assert reg.get("paddle_lock_contention_seconds") is not None
    assert reg.get("paddle_lock_held_seconds") is not None


def test_engine_adopts_instrumented_locks(sanitizer_on):
    from paddle_tpu_torch.models import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving import ServingEngine
    model = GPTForPretraining(gpt_config(
        "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
        device="cpu")
    engine = ServingEngine(model, max_batch=2, page_size=16, device="cpu")
    assert isinstance(engine._lock, lockwatch._WatchedLock)
    assert isinstance(engine._wake, threading.Condition)
    assert engine._wake._lock is engine._lock
    with engine:
        out = engine.submit([1, 2, 3], max_new_tokens=4).wait(
            timeout=120)
    assert len(out) == 4


# ---------------------------------------------------------------------------
# resilience.faults and the CLI (python -m paddle_tpu_torch.observability)
# ---------------------------------------------------------------------------

SCHEDULES = {
    "serving exc + stall": "serving_step@3=exc; serving_step@5=stall:6",
    "every kind": ("step@1=crash,step@2=exit:3,compile@1=exc:ValueError,"
                   "ckpt_write@2=truncate,collective@1=corrupt,"
                   "serving_step@2=nan"),
    "nan off serving_step": "step@1=nan",
    "truncate at step": "step@1=truncate",
    "unknown point": "nowhere@1=exc",
    "malformed": "serving_step=exc",
    "occurrence 0": "serving_step@0=exc",
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_fault_schedule_parses_as_the_reference(case):
    """The same schedule string parses to the same specs, or is refused
    with the same message, in both packages."""
    def parse(mod):
        try:
            return [(f.point, f.occurrence, f.kind, f.arg)
                    for f in mod.parse_schedule(SCHEDULES[case])]
        except ValueError as e:
            return str(e)
    assert parse(faults) == parse(jfaults)


def test_serving_poison_is_sticky_and_stall_fires_once():
    """``exc``/``nan`` at ``serving_step`` queue a poison directive for
    the engine instead of raising; ``stall`` sleeps at its occurrence
    only; the flag installs the schedule and refuses a malformed one."""
    set_flags({"FLAGS_fault_schedule":
               "serving_step@1=exc;serving_step@2=nan;"
               "serving_step@3=stall:0.05"})
    try:
        inj = faults.get_injector()
        faults.maybe_fault("serving_step")
        faults.maybe_fault("serving_step")
        assert faults.take_serving_poison() == ("exc", None)
        assert faults.take_serving_poison() == ("nan", None)
        assert faults.take_serving_poison() is None
        t0 = time.monotonic()
        faults.maybe_fault("serving_step")
        assert time.monotonic() - t0 >= 0.05
        t0 = time.monotonic()
        faults.maybe_fault("serving_step")
        assert time.monotonic() - t0 < 0.05
        assert inj.fired_log == [("serving_step", 1, "exc"),
                                 ("serving_step", 2, "nan"),
                                 ("serving_step", 3, "stall")]
        with pytest.raises(ValueError):
            set_flags({"FLAGS_fault_schedule": "serving_step@1=melt"})
    finally:
        set_flags({"FLAGS_fault_schedule": ""})
    assert faults.get_injector() is None


@pytest.fixture(scope="module")
def engine_log(tmp_path_factory):
    """One event log of the port's engine (tiny GPT, two requests, a
    traced request among them) plus two step records, and a second log
    of the same engine to baseline it against."""
    from paddle_tpu_torch.models import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving import ServingEngine
    model = GPTForPretraining(gpt_config(
        "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
        device="cpu", seed=1)
    dirs, trace_ids = [], []
    for i in range(2):
        d = str(tmp_path_factory.mktemp(f"cli{i}"))
        set_flags({"FLAGS_observability_dir": d})
        try:
            with ServingEngine(model, max_batch=2, page_size=8,
                               device="cpu") as eng:
                reqs = [eng.submit(list(range(3, 3 + n)), max_new_tokens=12)
                        for n in (5, 9)]
                for r in reqs:
                    r.wait(timeout=60)
            for s in range(8):
                events.emit("step", step=s, step_time_s=0.01 * (1 + s % 3),
                            loss=1.0 / (s + 1))
        finally:
            set_flags({"FLAGS_observability_dir": ""})
        dirs.append(d)
        trace_ids.append(reqs[0].trace.trace_id)
    return dirs, trace_ids[0]


CLI = {
    "report": lambda d, b, t: ["report", "--dir", d],
    "report --json": lambda d, b, t: ["report", "--dir", d, "--json"],
    "tail": lambda d, b, t: ["tail", "--dir", d, "-n", "7"],
    "tail --kind": lambda d, b, t: ["tail", "--dir", d, "--kind",
                                    "batch_step"],
    "trace": lambda d, b, t: ["trace", t, "--dir", d],
    "trace --json": lambda d, b, t: ["trace", t, "--dir", d, "--json"],
    "trace unknown": lambda d, b, t: ["trace", "0" * 32, "--dir", d],
    "watchdog self": lambda d, b, t: ["watchdog", "--dir", d],
    "watchdog baseline": lambda d, b, t: ["watchdog", "--dir", d,
                                          "--baseline", b, "--json"],
    "watchdog strict": lambda d, b, t: ["watchdog", "--dir", d,
                                        "--tolerance", "-0.9",
                                        "--min-seconds", "0"],
}


@pytest.mark.parametrize("case", list(CLI))
def test_cli_prints_what_the_reference_prints(engine_log, capsys, case):
    """Both CLIs over one event log of the port's engine: the same exit
    code and the same standard output."""
    (log, base), trace_id = engine_log
    argv = CLI[case](log, base, trace_id)
    got = []
    for main in (obs_main, jax_obs_main):
        rc = main(argv)
        got.append((rc, capsys.readouterr().out))
    assert got[0] == got[1]
    assert got[0][1] or case == "trace unknown"


def test_cli_snapshot_prints_the_registry(capsys):
    """``snapshot`` prints the process registry (each package its own):
    a family registered alike in both prints alike, in JSON and in the
    Prometheus text."""
    name = "paddle_cli_parity_total"
    for mod in (metrics, jmetrics):
        c = mod.counter(name, "a family both registries hold",
                        labels=("side",))
        c.labels(side="x").inc(3)
    outs = []
    for main, mod in ((obs_main, metrics), (jax_obs_main, jmetrics)):
        assert main(["snapshot"]) == 0
        snap = json.loads(capsys.readouterr().out)
        assert snap == json.loads(json.dumps(
            mod.default_registry().snapshot(), sort_keys=True))
        assert main(["snapshot", "--prometheus"]) == 0
        prom = [ln for ln in capsys.readouterr().out.splitlines()
                if name in ln]
        outs.append((snap[name], prom))
    assert outs[0] == outs[1]
