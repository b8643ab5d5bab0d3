"""The port's fleet serving tier (``paddle_tpu_torch.serving.fleet``,
``tuning.cache`` and ``python -m paddle_tpu_torch.tuning``,
``resilience.driver.restart_backoff``) held against the JAX package's
``paddle_tpu.serving.fleet`` on the CPU:

* the perf-model merge: both packages' ``merge_models`` / ``merge_heads``
  on the same ``perf_model.json`` files give the same version and the
  same predictions (rel 1e-12); both ``tuning merge`` CLIs round-trip
  and answer corrupt input with rc 2 and no output file;
* ``restart_backoff`` equal for restarts 0-10;
* the router: each package's ``FleetRouter`` over its own pair of stub
  replicas (``_StubReplica``, copied from ``tests/test_fleet.py``), the
  same request sequence: the same placed replica per request, affinity
  hits, predicted-cost placement, fleet stats and ``router_route``
  events; a resubmission after a stub dies mid-stream with the same
  stream; the 503 with ``Retry-After``; ``traceparent`` propagation;
  routing around a degraded replica and handing a failed one to the
  supervisor;
* both supervisors over the stub worker script: a killed replica
  restarts with one ``crash`` event, a rolling restart gives two
  ``rolling`` events;
* the whole slice: two real port workers (the tiny GPT with a JAX tiny
  GPT's weights carried over through an ``.npz``, served on the CPU)
  behind the port's router give the JAX engine's greedy tokens exactly,
  before and after the affinity owner is SIGKILLed mid-stream; and
  ``python -m paddle_tpu_torch.serving.fleet --worker --device cpu``
  publishes its port file, serves a stream and drains on SIGTERM with
  rc 0.

Every wait is bounded, so a wedged router or worker fails its test.
"""
from __future__ import annotations

import json
import math
import os
import random
import signal
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.inference import serving as jax_http
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.observability import events as jax_events
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.observability import tracing as jax_tracing
from paddle_tpu.resilience.driver import restart_backoff as jax_backoff
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import fleet as jax_fleet
from paddle_tpu.serving.fleet import replica as jax_replica
from paddle_tpu.tuning import learned as jax_learned
from paddle_tpu.tuning.__main__ import main as jax_tuning_main

from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference import serving as http
from paddle_tpu_torch.models import GPTForPretraining, gpt_config
from paddle_tpu_torch.observability import events
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.resilience.driver import restart_backoff
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.fleet import replica
from paddle_tpu_torch.tuning import TuningCache, get_cache
from paddle_tpu_torch.tuning import learned
from paddle_tpu_torch.tuning.__main__ import main as tuning_main

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30.0
_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)

PKG = {
    "jax": SimpleNamespace(
        Router=jax_fleet.FleetRouter, Supervisor=jax_fleet.ReplicaSupervisor,
        Handle=jax_replica.ReplicaHandle, http=jax_http,
        events=jax_events, tracing=jax_tracing, set_flags=jax_set_flags,
        metrics=jax_metrics,
        Model=jax_learned.LearnedPerfModel, Head=jax_learned._Head,
        merge_models=jax_fleet.merge_models,
        merge_heads=jax_fleet.perf_merge.merge_heads,
        tuning_main=jax_tuning_main),
    "port": SimpleNamespace(
        Router=fleet.FleetRouter, Supervisor=fleet.ReplicaSupervisor,
        Handle=replica.ReplicaHandle, http=http,
        events=events, tracing=tracing, set_flags=set_flags,
        metrics=metrics,
        Model=learned.LearnedPerfModel, Head=learned._Head,
        merge_models=fleet.merge_models,
        merge_heads=fleet.perf_merge.merge_heads,
        tuning_main=tuning_main),
}


# ---------------------------------------------------------------------------
# stub replica: the NDJSON /generate contract without an engine (a copy of
# tests/test_fleet.py's)
# ---------------------------------------------------------------------------

def _stub_token(ids, i):
    """Deterministic token stream: a resumed leg (prompt + generated
    so far) continues exactly where the dead leg stopped, so the test
    can simulate the full expected sequence."""
    return (sum(ids) + 31 * (len(ids) + i)) % 251


class _StubReplica:
    """Threaded HTTP server speaking the replica contract: streaming
    ``POST /generate``, gauge-bearing ``GET /metrics``.  Failure
    injection: ``die_after`` tokens (connection torn, no done line)
    for the first ``die_times`` requests."""

    def __init__(self, queue_depth=0.0, occupancy=0.0,
                 die_after=None, die_times=0, token_delay=0.0,
                 health=None):
        self.queue_depth = queue_depth
        self.occupancy = occupancy
        self.die_after = die_after
        self.die_times = die_times
        self.token_delay = token_delay
        # engine health gauge value (0 ok .. 3 failed); None omits the
        # family entirely, like a pre-health replica build
        self.health = health
        self.requests = []            # (spec, headers) per /generate
        self._lock = threading.Lock()
        outer = self

        class _H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                text = (
                    "# HELP paddle_serving_engine_queue_depth d\n"
                    "# TYPE paddle_serving_engine_queue_depth gauge\n"
                    'paddle_serving_engine_queue_depth{engine="s"} '
                    f"{outer.queue_depth}\n"
                    'paddle_serving_engine_batch_occupancy'
                    f'{{engine="s"}} {outer.occupancy}\n')
                if outer.health is not None:
                    text += ('paddle_serving_engine_health'
                             f'{{engine="s"}} {outer.health}\n')
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                spec = json.loads(self.rfile.read(n))
                with outer._lock:
                    outer.requests.append(
                        (spec, {k.lower(): v
                                for k, v in self.headers.items()}))
                    die = None
                    if outer.die_times > 0:
                        die = outer.die_after
                        outer.die_times -= 1
                ids = spec["input_ids"]
                max_new = spec["max_new_tokens"]
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.end_headers()
                toks = []
                for i in range(max_new):
                    if die is not None and i >= die:
                        # tear the stream: no done line, socket gone
                        self.wfile.flush()
                        self.connection.close()
                        return
                    tok = _stub_token(ids, i)
                    toks.append(tok)
                    self.wfile.write(json.dumps(
                        {"token": tok}).encode() + b"\n")
                    self.wfile.flush()
                    if outer.token_delay:
                        time.sleep(outer.token_delay)
                self.wfile.write(json.dumps(
                    {"done": True, "tokens": ids + toks,
                     "request_id": "stub"}).encode() + b"\n")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        # torn-stream injection closes sockets mid-handler on purpose
        self._httpd.handle_error = lambda *a: None
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    @property
    def url(self):
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def _expected_stream(prompt, max_new, die_after=None):
    """The fleet-level token stream: one leg, or a torn leg resumed by a
    survivor with the generated-so-far tokens kept."""
    ids = list(prompt)
    out = []
    i = 0
    for step in range(max_new):
        if die_after is not None and step == die_after:
            ids = ids + out     # resubmitted leg's prompt
            i = 0
        out.append(_stub_token(ids, i))
        i += 1
    return out


def _wait_until(cond, timeout=WAIT_S, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(every)
    return cond()


@pytest.fixture
def obs_dirs(tmp_path):
    """An event directory for each package."""
    dirs = {name: str(tmp_path / f"obs-{name}") for name in PKG}
    for name, pkg in PKG.items():
        pkg.set_flags({"FLAGS_observability_dir": dirs[name]})
    try:
        yield dirs
    finally:
        for pkg in PKG.values():
            pkg.set_flags({"FLAGS_observability_dir": ""})


def _generate(pkg, url, prompt, max_new=8, **kw):
    return list(pkg.http.generate_http(url, prompt, max_new_tokens=max_new,
                                       timeout=WAIT_S, **kw))


# ---------------------------------------------------------------------------
# perf merge, the tuning CLI and the shared backoff
# ---------------------------------------------------------------------------

def _model_json(seed, n_samples, version, scale=1e-3):
    """A perf_model.json document with one fitted batch_step head."""
    rng = random.Random(seed)
    samples = []
    for _ in range(16):
        f = {"batch": rng.randint(1, 8),
             "queue_depth": rng.randint(0, 5),
             "decode_seqs": rng.randint(0, 8),
             "tokens": rng.randint(1, 200)}
        s = scale * f["batch"] * (1 + 0.1 * f["decode_seqs"]) \
            * (1 + 0.02 * rng.random())
        samples.append((f, s))
    head = jax_learned._Head.fit("batch_step", samples)
    head.stats["n_samples"] = n_samples
    return jax_learned.LearnedPerfModel({"batch_step": head},
                                        version=version).to_dict()


FEATURES = [{"batch": 4, "queue_depth": 2, "decode_seqs": 3, "tokens": 77},
            {"batch": 1, "queue_depth": 0, "decode_seqs": 0, "tokens": 5},
            {"batch": 8, "queue_depth": 5, "decode_seqs": 8,
             "tokens": 512, "prefill_seqs": 1.0}]


def test_merge_models_matches_jax():
    docs = [_model_json(1, 10, 3), _model_json(2, 30, 7, scale=2e-3)]
    merged = {}
    for name, pkg in PKG.items():
        merged[name] = pkg.merge_models([pkg.Model.from_dict(d)
                                         for d in docs])
    assert merged["port"].version == merged["jax"].version == 8
    assert merged["port"].to_dict()["heads"] == \
        merged["jax"].to_dict()["heads"]
    for f in FEATURES:
        want = merged["jax"].predict("batch_step", f)
        assert merged["port"].predict("batch_step", f) == \
            pytest.approx(want, rel=1e-12)
    # the merge is the sample-weighted geometric mean of the sources
    srcs = [learned.LearnedPerfModel.from_dict(d) for d in docs]
    f = FEATURES[0]
    expect = math.exp((10 * math.log(srcs[0].predict("batch_step", f))
                       + 30 * math.log(srcs[1].predict("batch_step", f)))
                      / 40.0)
    assert merged["port"].predict("batch_step", f) == \
        pytest.approx(expect, rel=1e-9)


def test_merge_heads_disjoint_features_matches_jax():
    heads = {}
    for name, pkg in PKG.items():
        h1 = pkg.Head("batch_step", ["a"], [0.5], [2.0], [2.0], -3.0,
                      {"n_samples": 5})
        h2 = pkg.Head("batch_step", ["b"], [0.0], [1.0], [4.0], -1.0,
                      {"n_samples": 15})
        heads[name] = pkg.merge_heads([h1, h2])
    assert heads["port"].feature_names == heads["jax"].feature_names \
        == ["a", "b"]
    assert heads["port"].to_dict() == heads["jax"].to_dict()
    for f in ({"a": 1.0, "b": 2.0}, {"a": 7.0}, {}):
        assert heads["port"].predict(f) == pytest.approx(
            heads["jax"].predict(f), rel=1e-12)
    with pytest.raises(ValueError):
        fleet.merge_heads([])
    with pytest.raises(ValueError):
        fleet.merge_heads([learned._Head("flash", [], [], [], [], 0.0, {}),
                           learned._Head("step", [], [], [], [], 0.0, {})])


def test_tuning_merge_cli_roundtrip_matches_jax(tmp_path, capsys):
    paths = []
    for seed, n, ver in ((1, 10, 3), (2, 30, 7)):
        p = tmp_path / f"perf_model_{seed}.json"
        p.write_text(json.dumps(_model_json(seed, n, ver)))
        paths.append(str(p))
    out, summaries = {}, {}
    for name, pkg in PKG.items():
        out[name] = tmp_path / name / "perf_model.json"
        rc = pkg.tuning_main(["merge", *paths, "--out", str(out[name]),
                              "--json"])
        assert rc == 0
        summaries[name] = json.loads(capsys.readouterr().out)
    for s in summaries.values():
        s.pop("out")
    assert summaries["port"] == summaries["jax"]
    assert summaries["port"]["version"] == 8       # max(3, 7) + 1
    got = learned.LearnedPerfModel.from_dict(
        json.loads(out["port"].read_text()))
    want = jax_learned.LearnedPerfModel.from_dict(
        json.loads(out["jax"].read_text()))
    for f in FEATURES:
        assert got.predict("batch_step", f) == pytest.approx(
            want.predict("batch_step", f), rel=1e-12)
    # without --out the merge lands in the cache dir, where the learned
    # model's loader finds it
    cache_dir = tmp_path / "cache"
    assert tuning_main(["--dir", str(cache_dir), "merge", *paths]) == 0
    capsys.readouterr()
    assert learned.load_model(str(cache_dir)).version == 8


@pytest.mark.parametrize("name", list(PKG))
def test_tuning_merge_cli_rejects_corrupt_input(name, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for inputs in ([str(bad)], [str(tmp_path / "missing.json")]):
        rc = PKG[name].tuning_main(["merge", *inputs,
                                    "--out", str(tmp_path / "out.json")])
        assert rc == 2
        assert not (tmp_path / "out.json").exists()


def test_tuning_cli_fit_stats_dump_prune(tmp_path, capsys):
    """``fit --from-events`` trains the learned model from a serving
    engine's ``batch_step`` records; stats / dump / prune read and empty
    the cache; ``warm`` raises."""
    obs = tmp_path / "obs"
    obs.mkdir()
    rng = random.Random(0)
    with open(obs / "events.jsonl", "w") as fh:
        for i in range(24):
            b = rng.randint(1, 8)
            fh.write(json.dumps({
                "v": 1, "kind": "batch_step", "ts": 1e9 + i, "pid": 1,
                "run": "r", "batch": b, "prefill_seqs": 0,
                "decode_seqs": b, "tokens": b, "q_width": 1,
                "queue_depth": 0, "page_occupancy": 0.1,
                "fused_steps": 1, "step_s": 1e-3 * b}) + "\n")
    d = str(tmp_path / "cache")
    assert tuning_main(["--dir", d, "fit", "--from-events", str(obs)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["perf_model_version"] == 1
    assert learned.load_model(d).has("batch_step")
    # nothing trainable: rc 1
    assert tuning_main(["--dir", d, "fit"]) == 1
    capsys.readouterr()
    cache = TuningCache(d)
    cache.store("engine_plan", {"k": 1}, {"v": 2})
    assert tuning_main(["--dir", d, "stats"]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == \
        {"engine_plan": 1}
    assert tuning_main(["--dir", d, "dump", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)[0]["value"] == {"v": 2}
    assert tuning_main(["--dir", d, "prune"]) == 0
    assert capsys.readouterr().out.strip() == "pruned 1 entry"
    assert list(TuningCache(d).entries()) == []
    with pytest.raises(NotImplementedError):
        tuning_main(["--dir", d, "warm"])


def test_tuning_cache_survives_corruption_and_follows_the_flag(tmp_path):
    d = tmp_path / "cache"
    cache = TuningCache(str(d))
    cache.store("engine_plan", {"a": 1}, {"x": 1})
    with open(d / "engine_plan.jsonl", "a") as fh:
        fh.write("{torn\n")
        fh.write(json.dumps({"v": 99, "t": 0, "key": {}, "value": {}})
                 + "\n")
    fresh = TuningCache(str(d))
    assert fresh.lookup("engine_plan", {"a": 1}) == {"x": 1}
    assert fresh.lookup("engine_plan", {"a": 2}) is None
    st = fresh.stats()["engine_plan"]
    assert (st["hits"], st["misses"], st["corrupt_lines"],
            st["version_skew"]) == (1, 1, 1, 1)
    set_flags({"FLAGS_tuning_cache_dir": str(d)})
    try:
        assert get_cache().directory == str(d)
    finally:
        set_flags({"FLAGS_tuning_cache_dir": ""})
    assert get_cache() is None


def test_restart_backoff_matches_jax():
    for base, cap in ((0.5, 30.0), (0.05, 0.2), (1.0, 1e9)):
        for n in range(11):
            assert restart_backoff(n, base, cap) == \
                jax_backoff(n, base, cap)


# ---------------------------------------------------------------------------
# the router: each package's over its own stubs, the same requests
# ---------------------------------------------------------------------------

def _mk_router(pkg, stubs, **kw):
    kw.setdefault("poll_interval", 0.05)
    kw.setdefault("placement_wait_s", 2.0)
    return pkg.Router(replicas=[s.url for s in stubs], **kw)


def _placed(stubs, before):
    """Which stub took the request sent since ``before`` (its counts)."""
    got = [i for i, s in enumerate(stubs) if len(s.requests) > before[i]]
    assert len(got) == 1, got
    return got[0]


def _routes(pkg, obs_dir):
    return [{k: r.get(k) for k in ("replica", "affinity_pages",
                               "predicted_cost_s", "queue_depth",
                               "resubmitted", "candidates")}
            for r in pkg.events.read_events(obs_dir, kinds=["router_route"])]


def _stats(router):
    st = router.fleet_stats()
    st.pop("router")
    for r in st["replicas"]:
        r.pop("url")
    return st


def _place_sequence(pkg, obs_dir):
    """Affinity, then ties broken round-robin, then the owner made
    queue-deep (affinity still wins), then an unaffine prompt goes to the
    shallow queue."""
    # the registry is process-global: samples of earlier tests (another
    # router, a supervisor's restarts) are left out of the comparison
    seen = set(pkg.metrics.default_registry().prometheus_text()
               .splitlines())
    stubs = [_StubReplica().start(), _StubReplica().start()]
    router = _mk_router(pkg, stubs).start()
    shared = list(range(32))                 # two full pages of 16
    other = list(range(100, 132))
    seq = [shared + [7, 8], [5, 6, 7], other + [1], shared + [9],
           [1, 2, 3, 4], other + [2, 3], shared + [10, 11]]
    out = {"placed": [], "tokens": []}
    try:
        for i, prompt in enumerate(seq):
            if i == 4:
                owner = out["placed"][0]
                stubs[owner].queue_depth = 50.0
                assert _wait_until(lambda: router.endpoints[
                    owner].queue_depth == 50.0)
            before = [len(s.requests) for s in stubs]
            out["tokens"].append(_generate(pkg, router.url, prompt,
                                           max_new=3))
            out["placed"].append(_placed(stubs, before))
        text = urllib.request.urlopen(router.url + "/metrics",
                                      timeout=WAIT_S).read().decode()
        # the router's own families whose samples this scenario made or
        # moved, and the replicas' relabelled
        out["metrics"] = sorted({line.split("{")[0].split(" ")[0]
                                 for line in text.splitlines()
                                 if line.startswith("paddle_fleet_")
                                 and line not in seen})
        out["relabelled"] = 'paddle_serving_engine_queue_depth{engine=' \
            '"s",replica="1"}' in text
        out["stats"] = _stats(router)
        out["health"] = json.loads(urllib.request.urlopen(
            router.url + "/health", timeout=WAIT_S).read())["served"]
    finally:
        router.stop()
        for s in stubs:
            s.stop()
    out["routes"] = _routes(pkg, obs_dir)
    out["want_tokens"] = [_expected_stream(p, 3) for p in seq]
    return out


def _perf_model_placement(pkg, obs_dir):
    """A head pricing occupancy steeply: the queue-deep but idle replica
    wins, with the prediction on the route event."""
    head = pkg.Head("batch_step", ["decode_seqs"], mu=[0.0], sd=[1.0],
                    w=[1.0], b=-5.0, stats={"n_samples": 10})
    model = pkg.Model({"batch_step": head}, version=4)
    stubs = [_StubReplica(queue_depth=0.0, occupancy=6.0).start(),
             _StubReplica(queue_depth=3.0, occupancy=0.0).start()]
    router = _mk_router(pkg, stubs, perf_model=model).start()
    try:
        assert _wait_until(lambda: router.endpoints[0].occupancy == 6.0
                           and router.endpoints[1].queue_depth == 3.0)
        before = [len(s.requests) for s in stubs]
        tokens = _generate(pkg, router.url, [5, 6, 7], max_new=3)
        out = {"placed": [_placed(stubs, before)], "tokens": [tokens],
               "stats": _stats(router)}
    finally:
        router.stop()
        for s in stubs:
            s.stop()
    out["routes"] = _routes(pkg, obs_dir)
    return out


def _resubmission(pkg, obs_dir):
    """Replica 0 tears the stream after 3 tokens, once; replica 1 is
    queue-deep so the first leg lands on 0."""
    stubs = [_StubReplica(die_after=3, die_times=1).start(),
             _StubReplica(queue_depth=9.0).start()]
    router = _mk_router(pkg, stubs).start()
    prompt = [2, 4, 6]
    try:
        assert _wait_until(lambda: router.endpoints[1].queue_depth == 9.0)
        tokens = _generate(pkg, router.url, prompt, max_new=8)
        out = {"tokens": [tokens],
               "legs": [[(s[0]["input_ids"], s[0]["max_new_tokens"])
                         for s in stub.requests] for stub in stubs],
               "stats": _stats(router)}
    finally:
        router.stop()
        for s in stubs:
            s.stop()
    out["routes"] = _routes(pkg, obs_dir)
    return out


def _no_replica(pkg, obs_dir):
    router = _mk_router(pkg, [], placement_wait_s=0.2).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _generate(pkg, router.url, [1, 2], max_new=2, retries=1)
        return {"code": ei.value.code,
                "retry_after": ei.value.headers.get("Retry-After"),
                "stats": _stats(router)}
    finally:
        router.stop()


def _traceparent(pkg, obs_dir):
    stub = _StubReplica().start()
    router = _mk_router(pkg, [stub]).start()
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    tp = pkg.tracing.format_traceparent(tid, "00f067aa0ba902b7")
    try:
        _generate(pkg, router.url, [9, 9], max_new=2, traceparent=tp)
        hop = stub.requests[-1][1].get("traceparent")
    finally:
        router.stop()
        stub.stop()
    ctx = pkg.tracing.parse_traceparent(hop)
    spans = [s for s in pkg.events.read_events(obs_dir,
                                               kinds=["trace_span"])
             if s.get("name") == "fleet_request"]
    return {"same_trace": ctx.trace_id == tid, "reparented": hop != tp,
            "span_trace": [s["trace_id"] == tid for s in spans],
            "span_parent": [s.get("parent") for s in spans]}


def _degraded(pkg, obs_dir):
    stubs = [_StubReplica(health=1.0).start(),   # degraded
             _StubReplica().start()]             # no gauge: ok
    router = _mk_router(pkg, stubs).start()
    try:
        assert _wait_until(
            lambda: router.endpoints[0].health_state == "degraded"
            and router.endpoints[1].healthy)
        tokens = [_generate(pkg, router.url, [5, 6], max_new=2)
                  for _ in range(3)]
        out = {"tokens": tokens,
               "counts": [len(s.requests) for s in stubs],
               "stats": _stats(router)}
    finally:
        router.stop()
        for s in stubs:
            s.stop()
    return out


def _failed(pkg, obs_dir):
    stubs = [_StubReplica(health=3.0).start(), _StubReplica().start()]

    class _FakeSup:
        def __init__(self):
            self.replicas = []
            self.calls = []

        def restart_replica(self, rid, reason="health"):
            self.calls.append((rid, reason))
            return True

    sup = _FakeSup()
    for i, s in enumerate(stubs):
        h = pkg.Handle(str(i), port_file="")
        h.url = s.url
        sup.replicas.append(h)
    router = pkg.Router(supervisor=sup, poll_interval=0.05,
                        placement_wait_s=2.0).start()
    try:
        assert _wait_until(lambda: sup.calls)
        time.sleep(0.3)                   # more polls: still one restart
        out = {"calls": list(sup.calls)}
        out["tokens"] = _generate(pkg, router.url, [3, 1], max_new=3)
        out["counts"] = [len(s.requests) for s in stubs]
        stubs[0].health = 0.0             # recovery clears the debounce
        assert _wait_until(
            lambda: router.endpoints[0].health_state == "ok")
        stubs[0].health = 3.0
        assert _wait_until(lambda: len(sup.calls) == 2)
        out["calls_after"] = list(sup.calls)
    finally:
        router.stop()
        for s in stubs:
            s.stop()
    return out


SCENARIOS = {"placement": _place_sequence,
             "perf_model": _perf_model_placement,
             "resubmission": _resubmission,
             "no_replica": _no_replica,
             "traceparent": _traceparent,
             "degraded": _degraded,
             "failed": _failed}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_router_matches_jax(scenario, obs_dirs):
    got = {name: SCENARIOS[scenario](pkg, obs_dirs[name])
           for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    out = got["port"]
    if scenario == "placement":
        placed = out["placed"]
        owner = placed[0]
        # affinity: every prompt on the shared pages lands on its owner,
        # also once the owner is 50 deep; ties alternate
        assert [placed[i] for i in (0, 3, 6)] == [owner] * 3
        assert placed[1] != placed[0] and placed[5] == placed[2]
        assert placed[4] == 1 - owner
        assert out["tokens"] == out["want_tokens"]
        assert out["stats"]["affinity_hits"] == 3
        assert out["stats"]["served"] == out["health"] == 7
        assert out["stats"]["live"] == 2 and out["relabelled"]
        assert {"paddle_fleet_live_replicas", "paddle_fleet_routed_total",
                "paddle_fleet_affinity_hits_total"} <= set(out["metrics"])
        assert [r["affinity_pages"] for r in out["routes"]] == \
            [0, 0, 0, 2, 0, 2, 2]
        assert all(r["candidates"] == 2 for r in out["routes"])
    elif scenario == "perf_model":
        assert out["placed"] == [1]
        assert out["stats"]["model_version"] == 4
        assert out["routes"][-1]["predicted_cost_s"] > 0
    elif scenario == "resubmission":
        prompt = [2, 4, 6]
        tokens = out["tokens"][0]
        assert tokens == _expected_stream(prompt, 8, die_after=3)
        assert out["legs"] == [[(prompt, 8)], [(prompt + tokens[:3], 5)]]
        assert out["stats"]["resubmitted"] == 1
        assert [r["resubmitted"] for r in out["routes"]] == [False, True]
    elif scenario == "no_replica":
        assert (out["code"], out["retry_after"]) == (503, "1.0")
    elif scenario == "traceparent":
        assert out["same_trace"] and out["reparented"]
        assert out["span_trace"] == [True]
        assert out["span_parent"] == ["00f067aa0ba902b7"]
    elif scenario == "degraded":
        assert out["counts"] == [0, 3]
        assert [r["health_state"] for r in out["stats"]["replicas"]] == \
            ["degraded", "ok"]
    else:
        assert out["calls"] == [("0", "health")]
        assert out["counts"] == [0, 1]
        assert out["tokens"] == _expected_stream([3, 1], 3)
        assert out["calls_after"] == [("0", "health")] * 2


def test_router_fast_503_when_all_draining_then_recovers(obs_dirs):
    """Every replica draining: placement fails fast with 503 +
    Retry-After instead of holding the client for the placement window;
    un-draining resumes routing."""
    stubs = [_StubReplica().start(), _StubReplica().start()]
    pkg = PKG["port"]
    router = _mk_router(pkg, stubs, placement_wait_s=10.0).start()
    try:
        assert _wait_until(
            lambda: all(h.healthy for h in router.endpoints))
        for h in router.endpoints:
            h.draining = True
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _generate(pkg, router.url, [1, 2], max_new=2, retries=1)
        assert ei.value.code == 503
        assert time.monotonic() - t0 < 5.0
        for h in router.endpoints:
            h.draining = False
        assert _generate(pkg, router.url, [2, 4], max_new=4) == \
            _expected_stream([2, 4], 4)
    finally:
        router.stop()
        for s in stubs:
            s.stop()


# ---------------------------------------------------------------------------
# the supervisors over a stub worker
# ---------------------------------------------------------------------------

_STUB_WORKER = textwrap.dedent("""
    import json, os, sys, threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass
        def do_GET(self):
            body = (b'paddle_serving_engine_queue_depth{engine="w"} 0'
                    b'\\n')
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    h, p = httpd.server_address[:2]
    pf = sys.argv[1]
    with open(pf + ".tmp", "w") as fh:
        fh.write(f"http://{h}:{p}\\n")
    os.replace(pf + ".tmp", pf)
    httpd.serve_forever()
""")


def _supervise(pkg, script, obs_dir):
    sup = pkg.Supervisor(
        2, argv_builder=lambda rid, pf: [sys.executable, str(script), pf],
        max_restarts=3, restart_backoff_s=0.05, max_backoff_s=0.2,
        poll_interval=0.05, ready_timeout=WAIT_S, preempt_grace_s=5.0)
    sup.start()
    try:
        assert all(h.url for h in sup.replicas)
        sup.kill("0")
        assert _wait_until(lambda: sup.replicas[0].restarts == 1
                           and sup.replicas[0].alive
                           and sup.replicas[0].url is not None)
        crash = pkg.events.read_events(obs_dir, kinds=["replica_restart"])
        sup.rolling_restart()
        assert all(h.alive and h.url and not h.draining
                   for h in sup.replicas)
        with pytest.raises(KeyError):
            sup.kill("7")
        restarts = [h.restarts for h in sup.replicas]
    finally:
        sup.stop()
    assert not any(h.alive for h in sup.replicas)
    recs = pkg.events.read_events(obs_dir, kinds=["replica_restart"])
    return {"crash": [(e["replica"], e["reason"], e["restarts"])
                      for e in crash],
            "all": [(e["replica"], e["reason"]) for e in recs],
            "restarts": restarts}


def test_supervisor_matches_jax(tmp_path, obs_dirs):
    script = tmp_path / "stub_worker.py"
    script.write_text(_STUB_WORKER)
    got = {name: _supervise(pkg, script, obs_dirs[name])
           for name, pkg in PKG.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["crash"] == [("0", "crash", 1)]
    assert got["port"]["all"] == [("0", "crash"), ("0", "rolling"),
                                  ("1", "rolling")]
    assert got["port"]["restarts"] == [2, 1]


# ---------------------------------------------------------------------------
# the whole slice: real port workers behind the port's router
# ---------------------------------------------------------------------------

PAGE = 8
NEW = 24
N_STREAMS = 8

_REAL_WORKER = textwrap.dedent("""
    import os, signal, sys, threading
    import numpy as np
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.inference.serving import InferenceServer
    from paddle_tpu_torch.models import (GPTForPretraining, gpt_config,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.serving import ServingEngine

    port_file, weights = sys.argv[1], sys.argv[2]
    model = GPTForPretraining(gpt_config("tiny", hidden_dropout_prob=0.0,
                                         attention_dropout_prob=0.0),
                              device="cpu")
    with np.load(weights) as z:
        load_paddle_tpu_state(model, {k: z[k] for k in z.files})
    set_flags({"FLAGS_serving_engine": True})
    engine = ServingEngine(model, max_batch=8, page_size=%d,
                           device="cpu").start()
    srv = InferenceServer(engine=engine).start()
    with open(port_file + ".tmp", "w") as fh:
        fh.write(srv.url + "\\n")
    os.replace(port_file + ".tmp", port_file)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    srv.stop(drain_timeout=10.0)
    engine.stop(drain=True, timeout=10.0)
""" % PAGE)


def _prompts(vocab):
    rs = np.random.RandomState(0)
    shared = rs.randint(0, vocab, (2 * PAGE,)).tolist()
    out = [shared + rs.randint(0, vocab, (4,)).tolist()
           for _ in range(N_STREAMS // 2)]
    out += [rs.randint(0, vocab, (int(rs.randint(5, 20)),)).tolist()
            for _ in range(N_STREAMS - len(out))]
    return out


@pytest.fixture(scope="module")
def jax_oracle(tmp_path_factory):
    """The JAX tiny GPT's weights as an .npz and its engine's greedy
    tokens for the prompts."""
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
    jm.eval()
    path = str(tmp_path_factory.mktemp("weights") / "tiny_gpt.npz")
    np.savez(path, **{k: np.asarray(v._data)
                      for k, v in jm.state_dict().items()})
    prompts = _prompts(jm.config.vocab_size)
    engine = JaxEngine(jm, max_batch=N_STREAMS, page_size=PAGE).start()
    try:
        reqs = [engine.submit(p, max_new_tokens=NEW) for p in prompts]
        want = [list(r.wait(timeout=300)) for r in reqs]
    finally:
        engine.stop()
    return path, prompts, want


def _streams(router, prompts, on_token=None):
    """Every prompt as a concurrent greedy stream through the router."""
    outs = [None] * len(prompts)

    def run(i):
        toks = []
        try:
            for t in http.generate_http(router.url, prompts[i],
                                        max_new_tokens=NEW, timeout=120):
                toks.append(t)
                if on_token is not None:
                    on_token(i, len(toks))
            outs[i] = toks
        except (RuntimeError, OSError) as e:
            outs[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    return outs


def test_real_workers_give_jax_tokens_before_and_after_sigkill(
        jax_oracle, tmp_path, obs_dirs):
    weights, prompts, want = jax_oracle
    script = tmp_path / "worker.py"
    script.write_text(_REAL_WORKER)
    env = {"PYTHONPATH": os.pathsep.join(
        [_REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    sup = fleet.ReplicaSupervisor(
        2, argv_builder=lambda rid, pf: [sys.executable, str(script), pf,
                                         weights],
        env=env, max_restarts=2, restart_backoff_s=0.05,
        poll_interval=0.05, ready_timeout=120.0, preempt_grace_s=15.0)
    sup.start()
    router = None
    try:
        router = fleet.FleetRouter(sup, page_size=PAGE, poll_interval=0.1,
                                   placement_wait_s=60.0).start()
        # wave 1: every stream the JAX engine's tokens
        assert _streams(router, prompts) == want
        st = router.fleet_stats()
        assert st["affinity_hits"] >= N_STREAMS // 2 - 1
        owners = {r["replica"] for r in events.read_events(
            obs_dirs["port"], kinds=["router_route"])
            if r["affinity_pages"] == 2}
        assert len(owners) == 1
        owner = owners.pop()
        killed = threading.Event()

        def kill_owner(i, n):
            # a shared-prefix stream (routed to the owner) mid-way
            if i < N_STREAMS // 2 and n >= 4 and not killed.is_set():
                killed.set()
                sup.kill(owner)

        # wave 2: the owner dies mid-stream; every stream completes with
        # the same tokens
        assert _streams(router, prompts, on_token=kill_owner) == want
        assert killed.is_set()
        st = router.fleet_stats()
        assert st["resubmitted"] >= 1
        h = next(h for h in sup.replicas if h.id == owner)
        assert _wait_until(lambda: h.restarts == 1 and h.routable(),
                           timeout=120.0)
        crash = [e for e in events.read_events(
            obs_dirs["port"], kinds=["replica_restart"])
            if e["reason"] == "crash"]
        assert [e["replica"] for e in crash] == [owner]
        # the relaunched replica serves again
        assert _streams(router, prompts[:2]) == want[:2]
    finally:
        if router is not None:
            router.stop()
        sup.stop()
    assert not any(h.alive for h in sup.replicas)


def test_fleet_worker_entry_serves_and_drains(tmp_path):
    """``python -m paddle_tpu_torch.serving.fleet --worker --device cpu``
    at tiny widths: the port file, one stream (the tokens of the same
    seeded model's greedy ``generate``), a SIGTERM drain with rc 0."""
    port_file = str(tmp_path / "worker.port")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.fleet", "--worker",
         "--device", "cpu", "--port-file", port_file, "--layers", "2",
         "--hidden", "32", "--heads", "4", "--vocab", "64",
         "--max-pos", "64", "--seed", "5"], cwd=_REPO)
    try:
        assert _wait_until(lambda: os.path.exists(port_file)
                           or proc.poll() is not None, timeout=120.0)
        assert proc.poll() is None
        with open(port_file) as fh:
            url = fh.read().strip()
        assert url.startswith("http://127.0.0.1:")
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        got = list(http.generate_http(url, prompt, max_new_tokens=6,
                                      timeout=WAIT_S))
        cfg = gpt_config("tiny", num_layers=2, hidden_size=32, num_heads=4,
                         vocab_size=64, max_position_embeddings=64,
                         **_NO_DROPOUT)
        model = GPTForPretraining(cfg, device="cpu", seed=5)
        want = model.generate(np.array([prompt]), max_new_tokens=6)
        assert got == want[0, len(prompt):].tolist()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
