"""The PyTorch port's LLaMA serving held against the JAX package on the
CPU: tiny LLaMA weights made by ``paddle_tpu`` (GQA 4/2) are carried
into ``paddle_tpu_torch`` and both run the same inputs.

Tolerances: the ragged step's logits and the pools it writes within
atol = 2e-5, rtol 0 (fp32 on both sides; XLA and torch sum the products
and the softmax in different orders, a few ulps of values of order 1).
Tokens must be IDENTICAL: greedy serving by the port's engine against
``paddle_tpu``'s ``ServingEngine``, its eager ``generate`` and the port's
eager ``generate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.models import (LlamaForCausalLM, llama_config,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.serving import (PagePool, Request, Scheduler,
                                      ServingEngine)

ATOL = 2e-5
N_NEW = 6


def _pair(**overrides):
    """A JAX tiny LLaMA and the port's model carrying its weights."""
    paddle.seed(0)
    jm = JaxLlama(jax_llama_config("tiny", **overrides))
    jm.eval()
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = LlamaForCausalLM(llama_config("tiny", **overrides), device="cpu")
    load_paddle_tpu_state(pm, arrays)
    return jm, pm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _random_biases(jparams, tparams, seed):
    """Give both steps' params the same non-zero q/k/v biases (the
    initializers leave them 0, which would hide a bias dropped or
    misplaced)."""
    rs = np.random.RandomState(seed)
    jlayers = []
    for jl, tl in zip(jparams["layers"], tparams["layers"]):
        jl = dict(jl)
        for name in ("bq", "bk", "bv"):
            b = (0.1 * rs.randn(*tl[name].shape)).astype(np.float32)
            jl[name] = jnp.asarray(b)
            tl[name] = torch.from_numpy(b)
        jlayers.append(jl)
    return dict(jparams, layers=jlayers)


@pytest.mark.parametrize("bias,tied", [(False, False), (True, False),
                                       (False, True), (True, True)],
                         ids=["plain", "bias", "tied", "bias-tied"])
def test_ragged_step_logits_and_pools_match_jax(bias, tied):
    """A prefill step (two prompts), a mixed step (both decoding while a
    third prompt prefills) and a decode step, planned by the port's
    scheduler on identical pools; one slot stays empty throughout."""
    jm, pm = _pair(attention_bias=bias, tie_word_embeddings=tied)
    jparams, jstep = jm.build_ragged_decode_step()
    tparams, tstep = pm.build_ragged_decode_step()
    assert "layers" in tparams and len(tparams["layers"]) == 2
    if bias:
        jparams = _random_biases(jparams, tparams, seed=3)
    jstep = jax.jit(jstep)
    pool = PagePool(num_pages=16, page_size=8)
    sched = Scheduler(pool, max_batch=4, max_pages_per_seq=4)
    rs = np.random.RandomState(6)
    for n in (5, 12):
        sched.submit(Request(rs.randint(0, 256, (n,)), max_new_tokens=4))
    shape = (2, 16, 8, 16)                       # [nkv, P, ps, hd]: GQA
    jpools = tuple((jnp.zeros(shape, jnp.float32),
                    jnp.zeros(shape, jnp.float32)) for _ in range(2))
    tpools = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)]
    kinds = []
    for it in range(3):
        if it == 1:
            sched.submit(Request(rs.randint(0, 256, (9,)),
                                 max_new_tokens=4))
        plan, _, _ = sched.plan_step()
        kinds.append((plan.n_prefill, plan.n_decode, plan.tok.shape[1]))
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
            for j, tt in zip(jp, tp):
                np.testing.assert_allclose(tt[:, :pool.sink].numpy(),
                                           np.asarray(j)[:, :pool.sink],
                                           atol=ATOL, rtol=0)
        sched.commit(plan)
        nxt = tl.argmax(dim=-1).tolist()
        for i, seq in enumerate(plan.seqs):
            seq.tokens.append(nxt[i])
    # prefill, mixed (two decodes beside a 9-token prefill), decode
    assert kinds == [(2, 0, 12), (1, 2, 9), (0, 3, 1)]


def test_ragged_step_rope_at_other_positions_changes_the_logits(models):
    """chip_smoke's check and its fault control at tiny size: a prefill
    of all but the prompt's last token, then a decode step of the last,
    whose logits equal the dense forward's last row; the decode step
    with its rope rows gathered at ``pos - 1`` (the cached keys rotated
    at their own positions) leaves that tolerance.  At this width the
    random weights keep attention near uniform, so the control moves
    the logits by ~1e-3 only (the sound step by ~1e-7): it is held to
    20 x the tolerance."""
    _, pm = models
    params, step = pm.build_ragged_decode_step()
    prompt = np.random.RandomState(4).randint(0, 256, (17,)).tolist()
    dense = pm(torch.tensor([prompt]))[0, -1]
    errs = []
    for shift in (0, 1):
        pool = PagePool(num_pages=8, page_size=8)
        sched = Scheduler(pool, max_batch=2, max_pages_per_seq=4)
        sched.submit(Request(prompt[:-1], max_new_tokens=2))
        shape = (2, 8, 8, 16)
        pools = [(torch.zeros(shape), torch.zeros(shape))
                 for _ in range(2)]
        for it in range(2):
            plan, _, _ = sched.plan_step()
            t = [torch.from_numpy(a) for a in (
                plan.tok, plan.pos, plan.page_ids, plan.slots,
                plan.kv_lens, plan.q_lens, plan.tables)]
            if it == 1:
                t[1] = (t[1] - shift).clamp(min=0)
            logits, pools = step(params, t[0], t[1], pools, *t[2:])
            sched.commit(plan)
            plan.seqs[0].tokens.append(prompt[-1])
        errs.append((logits[0] - dense).abs().max().item())
    assert errs[0] < ATOL
    assert errs[1] > 20 * ATOL, errs


def _jax_greedy(jm, prompts):
    out = []
    for p in prompts:
        toks = jm.generate(Tensor(np.asarray([p], "int64")),
                           max_new_tokens=N_NEW, decode_strategy="greedy")
        out.append(np.asarray(toks._data)[0, len(p):].tolist())
    return out


def test_engine_matches_jax_engine_and_generate_gqa(models):
    """The shape of ``tests/test_serving.py``'s
    ``test_engine_matches_generate_llama_gqa``: the port's engine serves
    the tiny GQA LLaMA token for token as the JAX engine, the JAX eager
    ``generate`` and the port's eager ``generate``."""
    jm, pm = models
    assert pm.config.num_kv_heads < pm.config.num_heads
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 256, (n,)).tolist() for n in (7, 12)]
    want = _jax_greedy(jm, prompts)
    with JaxEngine(jm, max_batch=2, page_size=8) as jeng:
        jax_got = [jeng.submit(p, max_new_tokens=N_NEW).wait(timeout=120)
                   for p in prompts]
    engine = ServingEngine(pm, max_batch=2, page_size=8, device="cpu")
    assert engine.n_layers == 2
    assert engine._pools[0][0].shape == (2, engine.pool.num_pages, 8, 16)
    with engine:
        got = [engine.submit(p, max_new_tokens=N_NEW).wait(timeout=120)
               for p in prompts]
    eager = [pm.generate(torch.tensor([p]), max_new_tokens=N_NEW)
             [0, len(p):].tolist() for p in prompts]
    assert got == want == jax_got == eager
    st = engine.stats()
    assert st["failed_steps"] == 0 and st["kernel_launches"] == 0
    assert st["host_reads"] == st["dispatches"] == st["steps"]


def test_engine_serves_concurrent_llama_requests_with_prefix_hits(models):
    """Four concurrent requests, two sharing a 16-token prefix (two full
    pages): every token equals the port's eager greedy ``generate``, and
    the second of the pair hits the prefix cache."""
    _, pm = models
    rs = np.random.RandomState(2)
    shared = rs.randint(0, 256, (16,)).tolist()
    prompts = [shared + rs.randint(0, 256, (3,)).tolist(),
               rs.randint(0, 256, (10,)).tolist(),
               rs.randint(0, 256, (19,)).tolist()]
    late = shared + rs.randint(0, 256, (3,)).tolist()
    engine = ServingEngine(pm, max_batch=4, page_size=8, device="cpu")
    with engine:
        reqs = [engine.submit(p, max_new_tokens=N_NEW) for p in prompts]
        got = [r.wait(timeout=120) for r in reqs]
        got.append(engine.submit(late, max_new_tokens=N_NEW)
                   .wait(timeout=120))
    eager = [pm.generate(torch.tensor([p]), max_new_tokens=N_NEW)
             [0, len(p):].tolist() for p in prompts + [late]]
    assert got == eager
    assert engine.stats()["prefix_cache"]["hits"] >= 2
