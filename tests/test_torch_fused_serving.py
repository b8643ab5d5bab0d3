"""The port's fused serving window (``FLAGS_serving_fused_steps``) held
against the JAX package's ``build_fused_window_step`` and against the
port's own single-step engine, on the CPU at tiny sizes (GPT and LLaMA
weights made by ``paddle_tpu`` and carried into ``paddle_tpu_torch``).

Tolerances: the pools a window writes within atol = 2e-5, rtol 0 (fp32
on both sides, sums in different orders); the packed read (tokens,
finished mask, iteration count) IDENTICAL.  Engine tokens IDENTICAL
between ``FLAGS_serving_fused_steps`` 1 and 4, greedy and sampled (the
window draws from the engine's generator exactly as single steps do).
The EOS is picked from the port's own greedy run, at a token that
differs from the run's first, so that the window exits mid-way (the
seed's ``tests/test_serving.py`` EOS set-up finds no such token for its
prompt and fails before its engine runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config

from paddle_tpu_torch.flags import get_flags, set_flags
from paddle_tpu_torch.models import (GPTForPretraining, LlamaForCausalLM,
                                     gpt_config, llama_config,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.serving import (PagePool, Request, Scheduler,
                                      ServingEngine)

ATOL = 2e-5
W = 4
_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _carry(jm, pm):
    jm.eval()
    load_paddle_tpu_state(pm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, pm


@pytest.fixture(scope="module")
def pairs():
    paddle.seed(0)
    gpt = _carry(JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT)),
                 GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT),
                                   device="cpu"))
    paddle.seed(0)
    llama = _carry(JaxLlama(jax_llama_config("tiny")),
                   LlamaForCausalLM(llama_config("tiny"), device="cpu"))
    return {"gpt": gpt, "llama": llama}


@pytest.fixture
def fused():
    keep = get_flags(["FLAGS_serving_fused_steps"])
    set_flags({"FLAGS_serving_fused_steps": W})
    yield
    set_flags(keep)


@pytest.fixture
def obs_dir(tmp_path):
    set_flags({"FLAGS_observability_dir": str(tmp_path)})
    yield tmp_path
    set_flags({"FLAGS_observability_dir": ""})


def _geometry(pm):
    c = pm.config
    nkv = int(getattr(c, "num_kv_heads", c.num_heads))
    return nkv, c.hidden_size // c.num_heads, c.num_layers


def _decode_plan(pm, prompts):
    """Prefill ``prompts`` (one slot of four left empty) with the port's
    step and greedy tokens, then plan the decode step and budget a
    window of ``W``.  Returns (plan, pools after the prefill, pool)."""
    nkv, hd, n_layers = _geometry(pm)
    pool = PagePool(num_pages=24, page_size=8)
    sched = Scheduler(pool, max_batch=4, max_pages_per_seq=5)
    for p in prompts:
        sched.submit(Request(p, max_new_tokens=16))
    params, step = pm.build_ragged_decode_step()
    shape = (nkv, pool.num_pages, 8, hd)
    pools = [(torch.zeros(shape), torch.zeros(shape))
             for _ in range(n_layers)]
    plan, _, _ = sched.plan_step()
    t = [torch.from_numpy(a) for a in (plan.tok, plan.pos, plan.page_ids,
                                       plan.slots, plan.kv_lens,
                                       plan.q_lens, plan.tables)]
    logits, pools = step(params, t[0], t[1], pools, *t[2:])
    sched.commit(plan)
    for i, seq in enumerate(plan.seqs):
        tok = int(logits[i].argmax())
        seq.tokens.append(tok)
        seq.req._emit(tok)
    plan, _, _ = sched.plan_step()
    assert plan.n_prefill == 0 and plan.tok.shape[1] == 1
    assert sched.window_budget(plan, W) == (W, "window_full")
    return plan, pools, pool


def _window_inputs(plan, eos):
    b = plan.tok.shape[0]
    eos_ids = np.full((b,), -1, "int32")
    for lane, tok in eos.items():
        eos_ids[lane] = tok
    return dict(tok=plan.tok[:, 0].astype("int32"),
                kv_lens=(plan.kv_lens - plan.q_lens).astype("int32"),
                live=plan.q_lens > 0, tables=plan.tables,
                temps=plan.temps, eos_ids=eos_ids,
                budgets=np.full((b,), 16, "int32"))


def _torch_window(pm, inputs, pools):
    params, window = pm.build_fused_window_step(W)
    pools = [(k.clone(), v.clone()) for k, v in pools]
    gen = torch.Generator().manual_seed(0)
    states = []
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in inputs.items()}
    packed, pools = window(params, t["tok"], pools, t["kv_lens"],
                           t["live"], t["tables"], t["temps"],
                           t["eos_ids"], t["budgets"], gen, W,
                           rng_states=states)
    assert len(states) == W + 1
    return packed.numpy(), pools


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_window_matches_jax_window_with_mid_window_eos(pairs, family):
    """The same window inputs through the JAX ``lax.while_loop`` window
    and the port's host loop: one lane's EOS lands mid-window, so the
    JAX loop stops there and the port's remaining iterations must do
    nothing.  The packed read is identical and every page but the sink
    holds the same k/v."""
    jm, pm = pairs[family]
    rs = np.random.RandomState(11)
    for _ in range(50):
        prompts = [rs.randint(0, 200, (n,)).tolist() for n in (5, 11, 14)]
        plan, pools, pool = _decode_plan(pm, prompts)
        free_run, _ = _torch_window(pm, _window_inputs(plan, {}), pools)
        assert (free_run[:, W + 1] == W).all() and not free_run[:, W].any()
        # a lane whose greedy run changes token by iteration W - 2: its
        # first new token there is the EOS, so the window finishes early
        found = [(b, j) for b in range(3) for j in range(1, W - 1)
                 if free_run[b, j] != free_run[b, 0]]
        if found:
            break
    lane, j = found[0]
    eos = {lane: int(free_run[lane, j])}
    inputs = _window_inputs(plan, eos)
    got, tpools = _torch_window(pm, inputs, pools)
    steps = int(got[0, W + 1])
    assert steps <= j + 1 < W and got[lane, W] == 1

    jparams, jwindow = jm.build_fused_window_step(W)
    jpools = tuple((jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
                   for k, v in pools)
    want, jpools, _ = jax.jit(jwindow)(
        jparams, jnp.asarray(inputs["tok"]), jpools,
        jnp.asarray(inputs["kv_lens"]), jnp.asarray(inputs["live"]),
        jnp.asarray(inputs["tables"]), jnp.asarray(inputs["temps"]),
        jnp.asarray(inputs["eos_ids"]), jnp.asarray(inputs["budgets"]),
        jax.random.PRNGKey(0), jnp.int32(W))
    np.testing.assert_array_equal(got, np.asarray(want))
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        for j_, t_ in ((jk, tk), (jv, tv)):
            np.testing.assert_allclose(t_[:, :pool.sink].numpy(),
                                       np.asarray(j_)[:, :pool.sink],
                                       atol=ATOL, rtol=0)


def _eos_prompt(pm, rs, n, new):
    """A prompt of ``n`` tokens whose greedy run of ``new`` tokens
    changes token early enough that an EOS there lands inside a window,
    not on its last iteration (the prefill step emits token 0, windows
    of ``W`` the next ones, and the budget clamps the last window).
    Returns (prompt, (greedy tokens, eos)); the EOS is the run's first
    token that differs from its first, so it does not occur before."""
    for _ in range(100):
        prompt = rs.randint(0, 200, (n,)).tolist()
        full = pm.generate(torch.tensor([prompt]), max_new_tokens=new)[
            0, n:].tolist()
        i = next((i for i, t in enumerate(full) if t != full[0]), None)
        if i is not None and (i - 1) % W != W - 1 and i < new - 1:
            return prompt, (full, full[i])
    raise AssertionError("no prompt's greedy run changes token")


def _serve(pm, prompts, fused_steps, **kw):
    """Serve ``prompts`` concurrently at ``FLAGS_serving_fused_steps``;
    returns (tokens per request, engine stats).  Every request is queued
    before the loop starts, so the first step admits them all whatever
    the load on the host (the sampled draws follow the batches)."""
    keep = get_flags(["FLAGS_serving_fused_steps"])
    set_flags({"FLAGS_serving_fused_steps": fused_steps})
    try:
        engine = ServingEngine(pm, max_batch=4, page_size=8,
                               prefix_caching=False, seed=42, device="cpu")
        engine._accepting = True      # queue first, as the fault tests do
        reqs = [engine.submit(p, **(dict(kw, **extra)))
                for p, extra in prompts]
        with engine:
            got = [r.wait(timeout=120) for r in reqs]
        return got, engine.stats()
    finally:
        set_flags(keep)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_fused_engine_greedy_matches_single_step_and_generate(pairs,
                                                              family):
    _, pm = pairs[family]
    rs = np.random.RandomState(0)
    prompts = [(rs.randint(0, 200, (n,)).tolist(), {})
               for n in (5, 9, 16, 3)]
    single, st1 = _serve(pm, prompts, 1, max_new_tokens=8)
    got, st = _serve(pm, prompts, W, max_new_tokens=8)
    eager = [pm.generate(torch.tensor([p]), max_new_tokens=8)
             [0, len(p):].tolist() for p, _ in prompts]
    assert got == single == eager
    assert st["steps"] > st["dispatches"] == st["host_reads"]
    assert st1["steps"] == st1["dispatches"] == st1["host_reads"]
    assert st["decode_tokens"] == st1["decode_tokens"] == 32


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_fused_engine_sampled_and_eos_match_single_step(pairs, family):
    """RNG parity: two sampled requests beside a greedy one whose EOS
    lands mid-window.  The window's idle iterations after that finish
    draw from the generator too; restoring its state at the read leaves
    it where the single-step engine stands, so the sampled requests'
    later tokens agree as well."""
    _, pm = pairs[family]
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 200, (n,)).tolist() for n in (6, 11)]
    prompt, (greedy, eos) = _eos_prompt(pm, rs, 8, 10)
    prompts.append(prompt)
    spec = [(prompts[0], dict(temperature=0.8)),
            (prompts[1], dict(temperature=0.8)),
            (prompts[2], dict(eos_token_id=eos))]
    single, _ = _serve(pm, spec, 1, max_new_tokens=10)
    got, st = _serve(pm, spec, W, max_new_tokens=10)
    assert got == single
    assert got[2] == greedy[:greedy.index(eos) + 1]
    assert len(got[2]) < 10 and len(got[0]) == len(got[1]) == 10
    assert st["window_idle_iterations"] > 0
    assert st["steps"] > st["dispatches"] == st["host_reads"]


def test_fused_engine_eos_mid_window_event_and_pages(pairs, fused,
                                                     obs_dir):
    """EOS sampled mid-window: the output truncates as the eager
    ``generate`` with that EOS does, the last window's ``batch_step``
    record says it exited on the finish, and every page returns."""
    _, pm = pairs["gpt"]
    prompt, (full, eos) = _eos_prompt(pm, np.random.RandomState(0), 5, 8)
    want = full[:full.index(eos) + 1]
    engine = ServingEngine(pm, max_batch=2, page_size=8, device="cpu")
    with engine:
        free0 = engine.pool.available()
        got = engine.submit(prompt, max_new_tokens=8,
                            eos_token_id=eos).wait(timeout=60)
    assert got == want and len(got) < 8
    assert engine.pool.available() + len(engine.prefix_cache) == free0
    steps = obs_events.read_events(str(obs_dir), kinds=["batch_step"])
    windowed = [e for e in steps if e["exit_reason"] != "single_step"]
    assert windowed and windowed[-1]["exit_reason"] == "finished"
    assert all(e["exit_reason"] in ("single_step", "finished",
                                    "window_full", "page_limit")
               for e in steps)


def test_fused_window_exactly_one_host_read_per_window(pairs, fused,
                                                       obs_dir,
                                                       monkeypatch):
    """The contract of ``tests/test_serving.py``'s
    ``test_fused_window_exactly_one_host_sync_per_window``: one request
    at max_new 8 with windows of 4 runs prefill (1) + window (4) +
    window (3, its budget), with one device read each."""
    _, pm = pairs["gpt"]
    prompt = np.random.RandomState(6).randint(0, 200, (10,)).tolist()
    reads = {"cpu": 0, "item": 0, "tolist": 0}

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, **k):
            reads[name] += 1
            return orig(self, *a, **k)
        return wrapper

    engine = ServingEngine(pm, max_batch=2, page_size=8,
                           prefix_caching=False, device="cpu")
    for name in reads:
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    with engine:
        got = engine.submit(prompt, max_new_tokens=8).wait(timeout=60)
    monkeypatch.undo()
    assert len(got) == 8
    steps = obs_events.read_events(str(obs_dir), kinds=["batch_step"])
    assert [e["fused_steps"] for e in steps] == [1, 4, 3]
    st = engine.stats()
    assert st["dispatches"] == st["host_reads"] == 3 and st["steps"] == 8
    assert reads == {"cpu": 3, "item": 0, "tolist": 0}
    assert st["window_idle_iterations"] == 0


def test_fused_engine_eviction_pressure_keeps_tokens(pairs, fused):
    """Under page pressure the window budget clamps to 1 and the
    single-step path (with its eviction machinery) runs: the tokens
    still equal the unpressured run's."""
    _, pm = pairs["gpt"]
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 200, (12,)).tolist() for _ in range(3)]
    want = [pm.generate(torch.tensor([p]), max_new_tokens=12)
            [0, 12:].tolist() for p in prompts]
    engine = ServingEngine(pm, max_batch=3, page_size=8, num_pages=8,
                           max_pages_per_seq=4, prefix_caching=False,
                           device="cpu")
    with engine:
        got = [r.wait(timeout=120) for r in
               [engine.submit(p, max_new_tokens=12) for p in prompts]]
    assert engine.scheduler.evictions >= 1
    assert got == want
    assert engine.pool.available() == engine.pool.num_pages - 1


def test_fused_engine_prestages_plans(pairs, fused):
    """Queued work while windows run: the engine pre-stages the next
    boundary's admission on the host during each window."""
    _, pm = pairs["gpt"]
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 200, (8,)).tolist() for _ in range(4)]
    engine = ServingEngine(pm, max_batch=2, page_size=8,
                           prefix_caching=False, device="cpu")
    with engine:
        for r in [engine.submit(p, max_new_tokens=10) for p in prompts]:
            r.wait(timeout=120)
    st = engine.stats()
    assert st["prestaged_plans"] >= 1
    assert st["prestage_commits"] + st["prestage_discards"] \
        == st["prestaged_plans"]


# ---------------------------------------------------------------------------
# the scheduler's window bookkeeping (cases of tests/test_serving.py)
# ---------------------------------------------------------------------------

def _scheduler_decode_plan(sched, req):
    sched.submit(req)
    plan, _, _ = sched.plan_step()        # prefill step
    sched.commit(plan)
    seq = plan.seqs[0]
    seq.tokens.append(7)
    req._emit(7)                           # one sampled token out
    plan, _, _ = sched.plan_step()         # steady-state decode
    assert plan.n_prefill == 0 and plan.tok.shape[1] == 1
    return plan


def test_scheduler_window_budget_clamps_pages_and_budget():
    # page-limited: 3 usable pages, prompt holds 2 -> w clamps to 6
    pool = PagePool(4, 4)
    sched = Scheduler(pool, max_batch=2, max_pages_per_seq=8)
    plan = _scheduler_decode_plan(sched, Request(list(range(6)),
                                                 max_new_tokens=20))
    w, reason = sched.window_budget(plan, 16)
    assert (w, reason) == (6, "page_limit")
    seq = plan.seqs[0]
    assert len(seq.pages) == 3                 # ceil((6+6)/4) grown
    assert list(plan.tables[0, :3]) == seq.pages
    # early exit leaves over-allocated pages -> commit_window trims
    sched.commit_window(plan, 2)
    assert seq.kv_len == 8 and len(seq.pages) == 2

    # budget-limited: only 3 tokens of budget left -> w = 3
    pool = PagePool(64, 4)
    sched = Scheduler(pool, max_batch=2, max_pages_per_seq=8)
    plan = _scheduler_decode_plan(sched, Request(list(range(6)),
                                                 max_new_tokens=4))
    assert sched.window_budget(plan, 16)[0] == 3

    # w == 1 means "run the single-step path": nothing allocated
    pool = PagePool(64, 4)
    sched = Scheduler(pool, max_batch=2, max_pages_per_seq=8)
    plan = _scheduler_decode_plan(sched, Request(list(range(6)),
                                                 max_new_tokens=2))
    pages_before = len(plan.seqs[0].pages)
    assert sched.window_budget(plan, 16)[0] == 1
    assert len(plan.seqs[0].pages) == pages_before


def test_scheduler_prestage_commit_and_discard():
    """The staged projection is committed at the next boundary when the
    window exited as projected, and discarded when the state moved (the
    port stages no prediction: it has no perf model)."""
    pool = PagePool(64, 4)
    sched = Scheduler(pool, max_batch=2, max_pages_per_seq=8)
    sched.submit(Request([1, 2, 3], max_new_tokens=8))
    plan, _, _ = sched.plan_step()
    sched.commit(plan)
    seq = plan.seqs[0]
    seq.tokens.append(5)
    seq.req._emit(5)
    plan, _, _ = sched.plan_step()
    sched.commit(plan)
    seq.tokens.append(6)
    seq.req._emit(6)
    sched.submit(Request([4, 5, 6], max_new_tokens=8))

    sched.prestage_plan(plan, 4)
    assert sched.prestaged_plans == 1
    plan2, admitted, _ = sched.plan_step()
    assert sched.prestage_commits == 1 and len(admitted) == 1

    sched.submit(Request([7, 8, 9], max_new_tokens=8))
    sched.commit(plan2)
    for s in plan2.seqs:
        if not s.req.done:
            s.tokens.append(9)
            s.req._emit(9)
    sched.prestage_plan(plan2, 4)
    sched.finish(seq)                    # projection invalidated
    sched.plan_step()
    assert sched.prestage_discards == 1 and sched.prestaged_plans == 2

    # nothing queued: nothing staged
    sched2 = Scheduler(PagePool(8, 4), max_batch=2, max_pages_per_seq=2)
    sched2.prestage_plan(plan, 4)
    assert sched2.prestaged_plans == 0 and sched2._prestage is None
