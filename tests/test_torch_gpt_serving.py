"""The PyTorch port's GPT serving slice held against the JAX package on
the CPU: tiny GPT weights made by ``paddle_tpu`` (dropout 0) are carried
into ``paddle_tpu_torch`` and both run the same inputs.

Tolerances: logits within atol = 1e-5 (fp32 on both sides; the matmuls
and softmax sum in different orders in XLA and in torch, a few ulps of
logits of order 1).  Tokens must be IDENTICAL: greedy decode of the
port's engine against ``paddle_tpu``'s eager ``generate`` and its
``ServingEngine``.  EOS truncation is held against eager ``generate``
only (ROADMAP.md Queue 3: the JAX engine's EOS tests do not pass).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch import default_device
from paddle_tpu_torch.models import (GPTForPretraining, gpt_config,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.serving import (PagePool, PrefixCache, Request,
                                      Scheduler, ServingEngine)

ATOL = 1e-5
_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
    jm.eval()
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT), device="cpu")
    load_paddle_tpu_state(pm, arrays)
    return jm, pm


# ---------------------------------------------------------------------------
# weights and the model
# ---------------------------------------------------------------------------

def test_carry_checks_names_and_shapes_both_ways(models):
    _, pm = models
    arrays = {k: v.detach().numpy().copy()
              for k, v in pm.named_parameters()}
    with pytest.raises(KeyError, match="missing"):
        load_paddle_tpu_state(pm, {k: v for k, v in arrays.items()
                                   if k != "gpt.final_ln.bias"})
    with pytest.raises(KeyError, match="unexpected"):
        load_paddle_tpu_state(pm, dict(arrays, extra=np.zeros(1)))
    name = "gpt.layers.0.attn.qkv_proj.weight"
    assert arrays[name].shape == (64, 192)          # [in, out], packed
    with pytest.raises(ValueError, match="shape"):
        load_paddle_tpu_state(pm, dict(arrays, **{name: arrays[name].T}))


def test_dense_forward_matches_jax(models):
    jm, pm = models
    ids = np.random.RandomState(5).randint(0, 512, (2, 11))
    want = np.asarray(jm(Tensor(ids.astype("int64")))._data)
    got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ragged_step_logits_match_jax(models):
    """A prefill step and two decode steps on identical pools and page
    tables (planned by the port's scheduler, one slot left empty)."""
    import jax
    import jax.numpy as jnp
    jm, pm = models
    jparams, jstep = jm.build_ragged_decode_step()
    jstep = jax.jit(jstep)        # one compile per step shape
    tparams, tstep = pm.build_ragged_decode_step()
    pool = PagePool(num_pages=16, page_size=8)
    sched = Scheduler(pool, max_batch=4, max_pages_per_seq=4)
    rs = np.random.RandomState(6)
    for n in (5, 9, 12):
        sched.submit(Request(rs.randint(0, 512, (n,)), max_new_tokens=4))
    shape = (4, 16, 8, 16)                       # [nkv, P, ps, hd]
    jpools = tuple((jnp.zeros(shape, jnp.float32),
                    jnp.zeros(shape, jnp.float32)) for _ in range(2))
    tpools = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)]
    for it in range(3):
        plan, _, _ = sched.plan_step()
        assert plan.tok.shape[1] == (12 if it == 0 else 1)
        args = (plan.tok, plan.pos, plan.page_ids, plan.slots,
                plan.kv_lens, plan.q_lens, plan.tables)
        jl, jpools = jstep(jparams, *(jnp.asarray(a) for a in args[:2]),
                           jpools, *(jnp.asarray(a) for a in args[2:]))
        t = [torch.from_numpy(a) for a in args]
        tl, tpools = tstep(tparams, t[0], t[1], tpools, *t[2:])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        # every page but the sink, where padding rows land in an
        # unspecified order and which is never read
        for jp, tp in zip(jpools, tpools):
            for j, t in zip(jp, tp):
                np.testing.assert_allclose(t[:, :pool.sink].numpy(),
                                           np.asarray(j)[:, :pool.sink],
                                           atol=ATOL, rtol=0)
        sched.commit(plan)
        nxt = tl.argmax(dim=-1).tolist()
        for i, seq in enumerate(plan.seqs):
            seq.tokens.append(nxt[i])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

N_NEW = 8


@pytest.fixture(scope="module")
def prompts():
    """Four 20-token prompts, the first and last sharing a 16-token
    prefix (two full pages of 8).  One length keeps the JAX eager
    decode's per-shape compiles to a single set."""
    rs = np.random.RandomState(7)
    shared = rs.randint(0, 512, (16,)).tolist()
    return [shared + rs.randint(0, 512, (4,)).tolist(),
            rs.randint(0, 512, (20,)).tolist(),
            rs.randint(0, 512, (20,)).tolist(),
            shared + rs.randint(0, 512, (4,)).tolist()]


def _generate(jm, prompts, **kw):
    """paddle_tpu eager greedy ``generate`` over the batch; with an
    ``eos_token_id`` each row is cut after its first eos (generate pads
    finished rows with eos)."""
    out = jm.generate(Tensor(np.asarray(prompts, "int64")),
                      max_new_tokens=N_NEW, decode_strategy="greedy", **kw)
    rows = np.asarray(out._data)[:, len(prompts[0]):].tolist()
    eos = kw.get("eos_token_id")
    if eos is not None:
        rows = [r[:r.index(eos) + 1] if eos in r else r for r in rows]
    return rows


@pytest.fixture(scope="module")
def greedy_want(models, prompts):
    return _generate(models[0], prompts)


def _serve(engine, prompts, **kw):
    """The first three concurrently; the fourth (sharing the first's
    prefix) once they are done, so it can hit the prefix cache."""
    with engine:
        reqs = [engine.submit(p, max_new_tokens=N_NEW, **kw)
                for p in prompts[:3]]
        got = [r.wait(timeout=120) for r in reqs]
        got.append(engine.submit(prompts[3], max_new_tokens=N_NEW, **kw)
                   .wait(timeout=120))
    return got


def test_engine_greedy_matches_generate_and_jax_engine(models, prompts,
                                                       greedy_want):
    jm, pm = models
    jax_got = _serve(JaxEngine(jm, max_batch=4, page_size=8), prompts)
    engine = ServingEngine(pm, max_batch=4, page_size=8, device="cpu")
    got = _serve(engine, prompts)
    assert got == greedy_want
    assert got == jax_got
    st = engine.stats()
    assert st["prefix_cache"]["hits"] >= 2         # two full shared pages
    assert st["decode_tokens"] == 4 * N_NEW
    assert st["steps"] == st["dispatches"] > 0
    assert st["kernel_launches"] == 0              # CPU: plain route
    assert engine.pool.available() + len(engine.prefix_cache) \
        == engine.pool.num_pages - 1


def test_engine_eviction_under_pressure_keeps_tokens(models, prompts,
                                                     greedy_want):
    _, pm = models
    # 7 usable pages of 8 for three 28-token sequences (4 pages each)
    engine = ServingEngine(pm, max_batch=3, page_size=8, num_pages=8,
                           max_pages_per_seq=4, prefix_caching=False,
                           device="cpu")
    with engine:
        reqs = [engine.submit(p, max_new_tokens=N_NEW)
                for p in prompts[:3]]
        got = [r.wait(timeout=120) for r in reqs]
    assert engine.scheduler.evictions >= 1
    assert got == greedy_want[:3]
    assert engine.pool.available() == engine.pool.num_pages - 1


def test_engine_eos_matches_eager_generate(models, prompts, greedy_want):
    jm, pm = models
    # an eos some greedy row first emits mid-run, so the truncation is
    # observable
    row = next(r for r in greedy_want if r[0] != r[-2])
    eos = next(t for t in row if t != row[0])
    want = _generate(jm, prompts, eos_token_id=eos)
    assert any(len(w) < N_NEW for w in want)
    engine = ServingEngine(pm, max_batch=4, page_size=8, device="cpu")
    free0 = engine.pool.available()
    got = _serve(engine, prompts, eos_token_id=eos)
    assert got == want
    for g in got:
        assert eos not in g[:-1]
    assert engine.pool.available() + len(engine.prefix_cache) == free0


def test_engine_sampling_is_seeded_and_nan_fails_the_lane_alone(models):
    _, pm = models
    prompt = list(range(3, 12))
    runs = []
    for _ in range(2):
        with ServingEngine(pm, max_batch=2, page_size=8, seed=11,
                           device="cpu") as eng:
            runs.append(eng.submit(prompt, max_new_tokens=6,
                                   temperature=0.8).wait(timeout=60))
    assert runs[0] == runs[1] and len(runs[0]) == 6

    bad = GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT), device="cpu")
    with torch.no_grad():
        bad.gpt.final_ln.weight[0] = float("nan")
    with ServingEngine(bad, max_batch=2, page_size=8, device="cpu") as eng:
        req = eng.submit(prompt, max_new_tokens=4)
        # the NaN sentinel quarantines the lane, as in the JAX engine
        with pytest.raises(RuntimeError, match="quarantined: nan_logits"):
            req.wait(timeout=60)
        assert req.error_kind == "quarantined"
        assert eng.stats()["quarantined"] == 1


def test_engine_reads_the_device_once_per_step(models, prompts,
                                              monkeypatch):
    """The sampled tokens are the step's only device-to-host read:
    admission, eviction and EOS all key off it."""
    _, pm = models
    reads = {"cpu": 0, "item": 0, "tolist": 0}

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, **k):
            reads[name] += 1
            return orig(self, *a, **k)
        return wrapper

    for name in reads:
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    engine = ServingEngine(pm, max_batch=4, page_size=8, device="cpu")
    with engine:
        for r in [engine.submit(p, max_new_tokens=4) for p in prompts]:
            r.wait(timeout=60)
    assert reads == {"cpu": engine.stats()["steps"], "item": 0,
                     "tolist": 0}


def test_device_none_without_cuda_raises(models, monkeypatch):
    _, pm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForPretraining(gpt_config("tiny"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(pm)
    assert default_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# the copied scheduler and prefix cache (cases of tests/test_serving.py)
# ---------------------------------------------------------------------------

def test_page_pool_refcount_lifecycle():
    pool = PagePool(num_pages=4, page_size=8)
    assert pool.sink == 3 and pool.available() == 3
    a = pool.alloc()
    pool.ref(a)
    assert pool.refcount(a) == 2
    pool.unref(a)
    assert pool.available() == 2
    pool.unref(a)
    assert pool.available() == 3
    with pytest.raises(ValueError):
        pool.unref(a)                      # double free is loud
    for _ in range(3):
        pool.alloc()
    with pytest.raises(RuntimeError):
        pool.alloc()                       # the sink is never handed out


def test_prefix_cache_hash_collision_never_shares():
    pool = PagePool(num_pages=10, page_size=4)
    cache = PrefixCache(pool, hash_fn=lambda prev, toks: "SAME")
    a = pool.alloc()
    cache.insert([1, 2, 3, 4], [a])
    assert cache.match([5, 6, 7, 8]) == []
    assert cache.stats()["collisions"] == 1
    assert cache.match([1, 2, 3, 4]) == [a]


def test_scheduler_plan_layout_and_eviction_requeue():
    pool = PagePool(num_pages=3, page_size=4)
    sched = Scheduler(pool, max_batch=2, max_pages_per_seq=2)
    r1 = Request([1, 2, 3, 4], max_new_tokens=4)
    r2 = Request([5, 6, 7], max_new_tokens=4)
    sched.submit(r1)
    sched.submit(r2)
    plan, admitted, evicted = sched.plan_step()
    assert len(admitted) == 2 and not evicted
    assert plan.tok.shape == (2, 4) and plan.q_lens.tolist() == [4, 3]
    assert plan.slots[0].tolist() == [0, 1, 2, 3]
    assert plan.page_ids[1, 3] == pool.sink    # padding -> the sink
    sched.commit(plan)
    plan.seqs[0].tokens.append(10)
    plan.seqs[1].tokens.append(11)
    plan2, _, evicted2 = sched.plan_step()
    assert [s.req.id for s in evicted2] == [r2.id] and r2.evictions == 1
    assert [s.req.id for s in plan2.seqs] == [r1.id]
    sched.commit(plan2)
    sched.finish(plan2.seqs[0])
    plan3, admitted3, _ = sched.plan_step()
    assert [s.req.id for s in admitted3] == [r2.id]
    assert plan3.q_lens.tolist()[0] == 3
