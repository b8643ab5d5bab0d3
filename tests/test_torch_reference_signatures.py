"""Signatures of the port's public entry points outside ``nn.functional``
against the JAX package's: each takes the reference's parameters, in its
order, with its defaults and kinds (read with ``inspect.signature``);
only a keyword-only ``generator`` or ``device`` may follow them.  Then
what each repaired parameter does: where the port honours it, the same
as the reference (``embedding``'s ``padding_idx``, ``submit``'s
``request_id``, ``trace`` and ``deadline_s``, the engine's and the
scheduler's fault-containment and admission parameters, ``decorate``'s
``excluded_layers``, the attention's ``training``, ``stop``'s result);
where it does not, a value other than the default raises
``NotImplementedError``.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference import serving as jhttp
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import functional as jF
from paddle_tpu.optimizer import optimizer as jopt_base
from paddle_tpu.optimizer import optimizers as jopt
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving.fleet import perf_merge as jmerge
from paddle_tpu.serving.fleet import replica as jreplica
from paddle_tpu.serving.fleet import router as jrouter
from paddle_tpu.tuning import cache as jcache

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference import serving as thttp
from paddle_tpu_torch.models import GPTForPretraining, gpt_config
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.optimizer import optimizer as topt_base
from paddle_tpu_torch.optimizer import optimizers as topt
from paddle_tpu_torch.resilience import driver as tdriver
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving.fleet import perf_merge as tmerge
from paddle_tpu_torch.serving.fleet import replica as treplica
from paddle_tpu_torch.serving.fleet import router as trouter
from paddle_tpu_torch.tuning import cache as tcache

# the modules (each package's ``jit`` exports the function of that name)
jtrain = importlib.import_module("paddle_tpu.jit.train_step")
jdriver = importlib.import_module("paddle_tpu.resilience.driver")
ttrain = importlib.import_module("paddle_tpu_torch.jit.train_step")

# name: (the reference, the port)
PAIRS = {
    "ServingEngine.__init__": (jengine.ServingEngine.__init__,
                               tengine.ServingEngine.__init__),
    "ServingEngine.stop": (jengine.ServingEngine.stop,
                           tengine.ServingEngine.stop),
    "ServingEngine.submit": (jengine.ServingEngine.submit,
                             tengine.ServingEngine.submit),
    "Request.__init__": (jsched.Request.__init__, tsched.Request.__init__),
    "Scheduler.__init__": (jsched.Scheduler.__init__,
                           tsched.Scheduler.__init__),
    "Scheduler.window_budget": (jsched.Scheduler.window_budget,
                                tsched.Scheduler.window_budget),
    "Scheduler.commit_window": (jsched.Scheduler.commit_window,
                                tsched.Scheduler.commit_window),
    "Scheduler.prestage_plan": (jsched.Scheduler.prestage_plan,
                                tsched.Scheduler.prestage_plan),
    "build_fused_window_step": (jgen.build_fused_window_step,
                                tgen.build_fused_window_step),
    "InferenceServer.__init__": (jhttp.InferenceServer.__init__,
                                 thttp.InferenceServer.__init__),
    "generate_http": (jhttp.generate_http, thttp.generate_http),
    "embedding": (jF.embedding, tF.embedding),
    "auto_cast": (jamp.auto_cast, amp.auto_cast),
    "decorate": (jamp.decorate, amp.decorate),
    "Optimizer.__init__": (jopt_base.Optimizer.__init__,
                           topt_base.Optimizer.__init__),
    "Optimizer.clear_grad": (jopt_base.Optimizer.clear_grad,
                             topt_base.Optimizer.clear_grad),
    "Adam.__init__": (jopt.Adam.__init__, topt.Adam.__init__),
    "AdamW.__init__": (jopt.AdamW.__init__, topt.AdamW.__init__),
    "TrainStep.__init__": (jtrain.TrainStep.__init__,
                           ttrain.TrainStep.__init__),
    "train_step": (jtrain.train_step, ttrain.train_step),
    "MultiHeadAttention.forward": (jgpt.MultiHeadAttention.forward,
                                   tgpt.MultiHeadAttention.forward),
    "generate": (jgen.generate, tgen.generate),
    "FleetRouter.__init__": (jrouter.FleetRouter.__init__,
                             trouter.FleetRouter.__init__),
    "ReplicaSupervisor.__init__": (jreplica.ReplicaSupervisor.__init__,
                                   treplica.ReplicaSupervisor.__init__),
    "ReplicaSupervisor.rolling_restart": (
        jreplica.ReplicaSupervisor.rolling_restart,
        treplica.ReplicaSupervisor.rolling_restart),
    "ReplicaSupervisor.restart_replica": (
        jreplica.ReplicaSupervisor.restart_replica,
        treplica.ReplicaSupervisor.restart_replica),
    "merge_models": (jmerge.merge_models, tmerge.merge_models),
    "restart_backoff": (jdriver.restart_backoff, tdriver.restart_backoff),
    "TuningCache.__init__": (jcache.TuningCache.__init__,
                             tcache.TuningCache.__init__),
    "TuningCache.prune": (jcache.TuningCache.prune, tcache.TuningCache.prune),
}
EXTRA = {"generator", "device"}


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", list(PAIRS))
def test_signature_matches_reference(name):
    ref, port = PAIRS[name]
    extra = [p for p in _params(port) if p not in _params(ref)]
    assert all(kind is inspect.Parameter.KEYWORD_ONLY and pname in EXTRA
               for pname, kind, _ in extra), extra
    assert [p for p in _params(port) if p not in extra] == _params(ref)


# ---------------------------------------------------------------------------
# parameters the port does not support raise
# ---------------------------------------------------------------------------

def _param():
    return [torch.nn.Parameter(torch.zeros(3))]


def _tiny_gpt():
    return GPTForPretraining(gpt_config(
        "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
        device="cpu")


UNSUPPORTED = {
    "InferenceServer predictor": lambda: thttp.InferenceServer(
        predictor=object(), engine=object()),
    "auto_cast custom_white_list": lambda: amp.auto_cast(
        custom_white_list=["matmul"]).__enter__(),
    "auto_cast custom_black_list": lambda: amp.auto_cast(
        custom_black_list=["matmul"]).__enter__(),
    "auto_cast use_promote": lambda: amp.auto_cast(
        use_promote=False).__enter__(),
    "decorate save_dtype": lambda: amp.decorate(
        torch.nn.Linear(2, 2), save_dtype="float32"),
    "decorate master_grad": lambda: amp.decorate(
        torch.nn.Linear(2, 2), master_grad=True),
    "adam lazy_mode": lambda: optimizer.Adam(parameters=_param(),
                                             lazy_mode=True),
    "adam use_multi_tensor": lambda: optimizer.Adam(
        parameters=_param(), use_multi_tensor=True),
    "adamw lazy_mode": lambda: optimizer.AdamW(parameters=_param(),
                                               lazy_mode=True),
    "train_step mesh": lambda: ttrain.train_step(
        torch.nn.Linear(2, 2), lambda y: y.sum(), mesh=object()),
    "TrainStep batch_spec": lambda: ttrain.TrainStep(
        torch.nn.Linear(2, 2), lambda y: y.sum(), batch_spec=[None]),
    "generate unknown keyword": lambda: tgen.generate(
        _tiny_gpt(), np.zeros((1, 4), np.int64), max_new_tokens=1,
        attention_mask=None),
}


@pytest.mark.parametrize("case", list(UNSUPPORTED))
def test_unsupported_parameter_raises(case):
    with pytest.raises(NotImplementedError):
        UNSUPPORTED[case]()


class _BatchStepModel:
    """A learned-perf-model stand-in with a ``batch_step`` head."""

    def has(self, family):
        return family == "batch_step"

    def predict(self, family, feats):
        return 0.01


def _engine(**kw):
    return tengine.ServingEngine(_tiny_gpt(), max_batch=2, page_size=8,
                                 device="cpu", **kw)


def _scheduler(mod, **kw):
    return mod.Scheduler(mod.PagePool(8, 4), 2, 2, **kw)


# the parameters this port took and raised on until its fault-containment
# slice: each is now honoured as in the reference
HONOURED = {
    "engine perf_model": lambda: _engine(
        perf_model=_BatchStepModel(),
        max_step_cost_s=0.5).scheduler.perf_model.__class__.__name__
    == "_BatchStepModel",
    "engine max_step_cost_s": lambda: (
        lambda e: (e.scheduler.max_step_cost_s, e.scheduler.perf_model))(
        _engine(max_step_cost_s=0.5)) == (0.5, None),
    "engine health_recovery_steps": lambda: _engine(
        health_recovery_steps=8).health_recovery_steps == 8,
    "engine max_watchdog_relaunches": lambda: _engine(
        max_watchdog_relaunches=1).max_watchdog_relaunches == 1,
    "request deadline_s": lambda: all(
        (r.deadline_s, round(r.deadline_at - r.submitted_at, 6)) == (1.0, 1.0)
        for r in (jsched.Request([1, 2], deadline_s=1.0),
                  tsched.Request([1, 2], deadline_s=1.0))),
    "scheduler perf_model": lambda: all(
        isinstance(_scheduler(m, perf_model=_BatchStepModel()).perf_model,
                   _BatchStepModel) for m in (jsched, tsched)),
    "scheduler max_step_cost_s": lambda: all(
        _scheduler(m, max_step_cost_s=0.5).max_step_cost_s == 0.5
        for m in (jsched, tsched)),
}


@pytest.mark.parametrize("case", list(HONOURED))
def test_formerly_unported_parameter_is_honoured(case):
    assert HONOURED[case]()


# ---------------------------------------------------------------------------
# parameters the port honours
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding_idx", [None, 3, -2])
def test_embedding_padding_idx_matches_jax(padding_idx):
    rs = np.random.RandomState(0)
    w = rs.randn(10, 4).astype(np.float32)
    ids = np.array([[3, 8, 1], [8, 3, 0]])
    want = np.asarray(jF.embedding(Tensor(ids), Tensor(w),
                                   padding_idx=padding_idx)._data)
    got = tF.embedding(torch.from_numpy(ids), torch.from_numpy(w),
                       padding_idx=padding_idx, sparse=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def engine_model():
    return _tiny_gpt()


def test_submit_takes_the_request_id_and_rejects_trace(engine_model,
                                                      tmp_path):
    """``request_id`` names the request; ``trace`` is honoured (a
    ``TraceContext`` parents the request's root span, as in the
    reference), and so is ``deadline_s`` (a deadline the request meets
    changes nothing)."""
    eng = tengine.ServingEngine(engine_model, max_batch=2, page_size=8,
                                device="cpu").start()
    parent = ttracing.TraceContext(ttracing.new_trace_id(),
                                   ttracing.new_span_id())
    set_flags({"FLAGS_observability_dir": str(tmp_path)})
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=2, request_id="r-7")
        assert req.id == "r-7"
        assert len(req.wait(timeout=60)) == 2
        traced = eng.submit([1, 2, 3], max_new_tokens=2, trace=parent)
        assert len(traced.wait(timeout=60)) == 2
        assert traced.trace.trace_id == parent.trace_id
        assert traced.trace.span_id != parent.span_id
        timed = eng.submit([1, 2, 3], max_new_tokens=2, deadline_s=60.0)
        assert timed.deadline_s == 60.0 and len(timed.wait(timeout=60)) == 2
    finally:
        set_flags({"FLAGS_observability_dir": ""})
        eng.stop()


def test_stop_returns_the_reference_keys(engine_model):
    """``stop`` returns the reference's keys: the engine's id, its
    health and whether the loop thread failed to join; ``stop(False)``
    fails what is queued instead of draining it."""
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.gpt_config(
        "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0))
    jeng = jengine.ServingEngine(jm, max_batch=2, page_size=8).start()
    want = set(jeng.stop())
    eng = tengine.ServingEngine(engine_model, max_batch=2, page_size=8,
                                device="cpu").start()
    res = eng.stop()
    assert set(res) == want == {"engine", "health", "wedged"}
    assert res == {"engine": eng.engine_id, "health": "ok",
                   "wedged": False}
    eng = tengine.ServingEngine(engine_model, max_batch=2, page_size=8,
                                device="cpu")
    eng._running = eng._accepting = True      # accepting, no loop thread
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    assert eng.stop(False) == {"engine": eng.engine_id, "health": "ok",
                               "wedged": False}
    assert req.done and req.error == "engine stopped"


def test_weight_decay_and_name_reach_the_base():
    opt = optimizer.AdamW(parameters=_param(), weight_decay=0.05, name="o")
    assert opt._weight_decay == 0.05 and opt._wd == 0.05
    assert opt._name == "o"


@pytest.mark.parametrize("set_to_zero", [True, False])
def test_clear_grad_drops_gradients_as_the_reference(set_to_zero):
    p = _param()
    opt = optimizer.AdamW(parameters=p)
    p[0].grad = torch.ones(3)
    opt.clear_grad(set_to_zero)
    assert p[0].grad is None


def test_decorate_keeps_excluded_layers_in_fp32():
    m = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Conv1d(2, 2, 1))
    amp.decorate(m, level="O2", dtype="bfloat16",
                 excluded_layers=[torch.nn.Conv1d])
    assert m[0].weight.dtype == torch.bfloat16
    assert m[1].weight.dtype == torch.float32


def test_attention_training_flag_drives_dropout():
    """``training=False`` is the eval attention whatever the module's mode;
    ``training=True`` drops (attention dropout 0.5)."""
    m = GPTForPretraining(gpt_config("tiny", hidden_dropout_prob=0.0,
                                     attention_dropout_prob=0.5),
                          device="cpu")
    attn = m.gpt.layers[0].attn
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 5, 64).astype(np.float32))
    m.eval()
    want = attn(x, training=False)
    m.train()
    torch.testing.assert_close(attn(x, training=False), want, rtol=0,
                               atol=0)
    assert not torch.equal(attn(x, training=True), want)


def test_generate_takes_generator_by_keyword_only():
    m = _tiny_gpt()
    ids = np.random.RandomState(2).randint(0, 512, (1, 4))
    params = inspect.signature(tgen.generate).parameters
    assert params["generator"].kind is inspect.Parameter.KEYWORD_ONLY
    out = tgen.generate(m, ids, 2, None, "sampling", 1.0, 0, 1.0, None, 1,
                        1.0, None, True, False, None,
                        generator=torch.Generator().manual_seed(0))
    again = tgen.generate(m, ids, 2, decode_strategy="sampling",
                          generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 6) and torch.equal(out, again)
    with pytest.raises(TypeError):
        tgen.generate(m, ids, 2, None, "greedy_search", 1.0, 0, 1.0, None,
                      1, 1.0, None, True, False, None,
                      torch.Generator())
