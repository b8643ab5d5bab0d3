"""HTTP ``/generate`` of the port (``paddle_tpu_torch.inference.serving``)
on the CPU, held against the JAX package's ``InferenceServer``: the same
requests answer the same status codes from both, and the port's streams
carry the tokens of its eager ``generate`` (tiny GPT, greedy: tokens
IDENTICAL).

Every socket wait is bounded: each request and each stream read has a
``HTTP_TIMEOUT`` of its own and every client thread is joined with a
timeout, so a server that stops answering fails its test instead of
hanging the suite.
"""
import json
import threading
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
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference.serving import (InferenceServer,
                                                generate_http)
from paddle_tpu_torch.models import GPTForPretraining, gpt_config
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.serving import ServingEngine

HTTP_TIMEOUT = 30.0
_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


@pytest.fixture(scope="module")
def model():
    return GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT), device="cpu")


@pytest.fixture(scope="module", autouse=True)
def engine_flag():
    """``FLAGS_serving_engine`` on in both packages for every test here."""
    set_flags({"FLAGS_serving_engine": True})
    jax_set_flags({"FLAGS_serving_engine": True})
    yield
    set_flags({"FLAGS_serving_engine": False})
    jax_set_flags({"FLAGS_serving_engine": False})


@pytest.fixture(scope="module")
def servers(model):
    """The port's server and the JAX package's, each over its own engine
    and tiny GPT."""
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
    jm.eval()
    engines = {"port": ServingEngine(model, max_batch=4, page_size=8,
                                     device="cpu").start(),
               "jax": JaxEngine(jm, max_batch=4, page_size=8).start()}
    srvs = {"port": InferenceServer(engine=engines["port"]).start(),
            "jax": JaxServer(engine=engines["jax"]).start()}
    yield srvs
    for name in srvs:
        srvs[name].stop(drain_timeout=HTTP_TIMEOUT)
        engines[name].stop()


def _status(url, path, body=None, headers=None):
    """(status, headers, body) of one request; HTTP errors included."""
    req = urllib.request.Request(url + path, data=body,
                                 method="GET" if body is None else "POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _json(obj):
    return json.dumps(obj).encode()


CASES = {
    "malformed body": ("/generate", b"not json", 400),
    "empty input_ids": ("/generate", _json({"input_ids": []}), 400),
    "input_ids not a list": ("/generate", _json({"input_ids": 7}), 400),
    "too long for a sequence": ("/generate", _json(
        {"input_ids": list(range(500)), "max_new_tokens": 5000}), 400),
    "unknown POST path": ("/nowhere", _json({}), 404),
    "unknown GET path": ("/nowhere", None, 404),
    "health": ("/health", None, 200),
    "metrics": ("/metrics", None, 200),
    "debug trace": ("/debug/trace", None, 200),
    "non-streaming generate": ("/generate", _json(
        {"input_ids": [1, 2, 3], "max_new_tokens": 2, "stream": False}),
        200),
}


@pytest.mark.parametrize("case", list(CASES))
def test_status_codes_match_the_reference(servers, case):
    path, body, want = CASES[case]
    got = {name: _status(srv.url, path, body)[0]
           for name, srv in servers.items()}
    assert got == {"port": want, "jax": want}


def test_flag_off_answers_404_in_both(servers):
    body = _json({"input_ids": [1, 2, 3]})
    set_flags({"FLAGS_serving_engine": False})
    jax_set_flags({"FLAGS_serving_engine": False})
    try:
        got = {name: _status(srv.url, "/generate", body)[0]
               for name, srv in servers.items()}
    finally:
        set_flags({"FLAGS_serving_engine": True})
        jax_set_flags({"FLAGS_serving_engine": True})
    assert got == {"port": 404, "jax": 404}


def _eager(model, prompt, n):
    return model.generate(torch.tensor([prompt]), max_new_tokens=n)[
        0, len(prompt):].tolist()


def test_generate_http_stream_and_nonstream(servers, model):
    srv = servers["port"]
    prompt = np.random.RandomState(0).randint(0, 512, (9,)).tolist()
    want = _eager(model, prompt, 6)
    got = list(generate_http(srv.url, prompt, max_new_tokens=6,
                             timeout=HTTP_TIMEOUT))
    assert got == want
    code, _, body = _status(srv.url, "/generate", _json(
        {"input_ids": prompt, "max_new_tokens": 6, "stream": False}))
    payload = json.loads(body)
    assert code == 200 and payload["tokens"] == want
    _, _, body = _status(srv.url, "/health")
    health = json.loads(body)
    assert health["engine"]["queue_depth"] == 0
    assert health["served"] >= 2
    _, _, body = _status(srv.url, "/metrics")
    text = body.decode()
    for name in ("paddle_serving_engine_request_seconds_bucket",
                 "paddle_serving_engine_queue_depth",
                 "paddle_serving_engine_dispatches_total",
                 "paddle_serving_requests_total"):
        assert name in text


def test_concurrent_streams_and_metrics_count_them(model):
    """Four concurrent ``generate_http`` streams on a fresh server: each
    equals the eager tokens, and ``/metrics`` counts four served
    requests for this server and their decode tokens for its engine."""
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 512, (n,)).tolist() for n in (4, 9, 13, 17)]
    want = [_eager(model, p, 5) for p in prompts]
    outs = [None] * 4
    with ServingEngine(model, max_batch=4, page_size=8,
                       device="cpu") as eng:
        with InferenceServer(engine=eng) as srv:
            def run(i):
                outs[i] = list(generate_http(srv.url, prompts[i],
                                             max_new_tokens=5,
                                             timeout=HTTP_TIMEOUT))
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=2 * HTTP_TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            # a handler counts its request after writing the done line
            # the client returns on
            deadline = time.monotonic() + HTTP_TIMEOUT
            while srv.served < 4 and time.monotonic() < deadline:
                time.sleep(0.005)
            _, _, body = _status(srv.url, "/metrics")
    assert outs == want
    text = body.decode()
    assert (f'paddle_serving_requests_total{{outcome="served",server='
            f'"{srv.server_id}"}} 4') in text
    assert (f'paddle_serving_engine_tokens_total{{engine='
            f'"{eng.engine_id}",phase="decode"}} 20') in text


def test_overload_503_and_stop_drains_the_stream(model):
    """``max_in_flight=1``: a stream holds the only slot, so a second
    request answers 503 with ``Retry-After``; ``stop()`` drains the
    stream (all its tokens arrive) before closing."""
    engine = ServingEngine(model, max_batch=2, page_size=8,
                           device="cpu").start()
    srv = InferenceServer(engine=engine, max_in_flight=1).start()
    result = {}

    def long_stream():
        result["toks"] = list(generate_http(
            srv.url, [5, 6, 7, 8, 9, 10, 11, 12], max_new_tokens=24,
            retries=1, timeout=HTTP_TIMEOUT))

    t = threading.Thread(target=long_stream)
    try:
        t.start()
        deadline = time.monotonic() + HTTP_TIMEOUT
        while time.monotonic() < deadline:         # wait until admitted
            with srv._state:
                if srv._in_flight == 1:
                    break
            time.sleep(0.005)
        code, headers, _ = _status(srv.url, "/generate",
                                   _json({"input_ids": [1, 2, 3]}))
        assert code == 503 and headers.get("Retry-After") == "1"
        stopper = threading.Thread(
            target=lambda: srv.stop(drain_timeout=HTTP_TIMEOUT))
        stopper.start()
        t.join(timeout=2 * HTTP_TIMEOUT)
        stopper.join(timeout=2 * HTTP_TIMEOUT)
        assert not t.is_alive() and not stopper.is_alive()
    finally:
        engine.stop()
    assert len(result.get("toks", [])) == 24
    assert srv.rejected == 1 and srv.served == 1


def test_traceparent_is_echoed_and_parents_the_request(servers, tmp_path):
    """A client ``traceparent`` parents the request's root span; the
    response echoes the trace id with the server root span's id, and the
    event log holds the root, its queue span and the linked steps."""
    srv = servers["port"]
    client_trace = tracing.new_trace_id()
    client_span = tracing.new_span_id()
    header = tracing.format_traceparent(client_trace, client_span)
    set_flags({"FLAGS_observability_dir": str(tmp_path)})
    try:
        code, headers, _ = _status(
            srv.url, "/generate",
            _json({"input_ids": [3, 4, 5], "max_new_tokens": 3,
                   "stream": False}),
            headers={tracing.TRACEPARENT_HEADER: header})
    finally:
        set_flags({"FLAGS_observability_dir": ""})
    assert code == 200
    echoed = tracing.parse_traceparent(
        headers.get(tracing.TRACEPARENT_HEADER))
    assert echoed is not None and echoed.trace_id == client_trace
    assert echoed.span_id != client_span
    recs = obs_events.read_events(str(tmp_path))
    spans = {r["name"]: r for r in recs if r["kind"] == "trace_span"
             and r.get("trace_id") == client_trace}
    assert spans["serving_request"]["parent"] == client_span
    assert spans["serving_request"]["span"] == echoed.span_id
    assert spans["queue"]["parent"] == echoed.span_id
    assert spans["serving_request"]["status"] == "ok"
    tree = tracing.build_trace(recs, client_trace)
    assert tree["linked"] and all(s["name"] == "batch_step"
                                  for s in tree["linked"])
    admits = [r for r in recs if r["kind"] == "serving_admit"]
    assert admits and admits[0]["trace_id"] == client_trace


def test_unported_fields_answer_501(servers):
    """``deadline_s`` now reaches the engine and is honoured: a deadline
    the request can meet answers 200 with its tokens from both servers
    (the 503 of a doomed one is held in
    ``test_torch_serving_faults.py``); ``/predict`` has no Predictor
    behind it: 501; and the server refuses a predictor."""
    srv = servers["port"]
    body = _json({"input_ids": [1, 2, 3], "max_new_tokens": 2,
                  "deadline_s": 60.0, "stream": False})
    for name in ("port", "jax"):
        code, _, raw = _status(servers[name].url, "/generate", body)
        assert code == 200 and len(json.loads(raw)["tokens"]) == 2, name
    assert _status(srv.url, "/predict", b"x")[0] == 501
    with pytest.raises(NotImplementedError):
        InferenceServer(predictor=object(), engine=object())
    with pytest.raises(ValueError):
        InferenceServer()
