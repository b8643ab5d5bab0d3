"""The decode loop of the PyTorch port (``models.generation`` ``generate``
and ``decode_loop``, the models' cache-aware forward and
``build_decode_step``) held against the JAX package on the CPU.  Tiny
GPT and LLaMA weights (GQA 4/2, the sizes of ``tests/test_decode_loop.py``)
are made by ``paddle_tpu`` and carried into the port.

Tolerances: logits within 2e-5 (fp32 on both sides; matmuls and softmax
sum in other orders in XLA and in torch, a few ulps of logits of order
1).  Tokens must be IDENTICAL: greedy tokens of the port's compiled and
eager loops against the JAX package's compiled and eager loops, with its
fused decode kernels in interpret mode and on its reference route; the
sampler against ``jax.random.categorical`` given JAX's own Gumbel noise.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch.models import (GPTForPretraining, LlamaConfig,
                                     LlamaForCausalLM, gpt_config,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models import generation as tgen

ATOL = 2e-5
_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
_LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=64,
              max_position_embeddings=64)
IDS = np.array([[3, 9, 17, 25], [4, 8, 15, 16]], np.int64)


def _carry(jm, pm):
    jm.eval()
    load_paddle_tpu_state(pm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, pm


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    gpt = _carry(JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT)),
                 GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT),
                                   device="cpu"))
    paddle.seed(2)
    llama = _carry(JaxLlama(JaxLlamaConfig(**_LLAMA)),
                   LlamaForCausalLM(LlamaConfig(**_LLAMA), device="cpu"))
    return {"gpt": gpt, "llama": llama}


@pytest.fixture
def interpret():
    keep = get_flags(["FLAGS_pallas_interpret"])
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags(keep)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, Tensor):
        x = x._data
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the cache-aware forward and the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_prefill_logits_and_past_match_jax(models, name):
    """Prefill with ``last_logits_only``, then two more tokens fed with the
    past: logits and caches equal the JAX model's."""
    jm, pm = models[name]
    jl, jpast = jm(Tensor(IDS), use_cache=True, last_logits_only=True)
    tl, tpast = pm(torch.from_numpy(IDS), use_cache=True,
                   last_logits_only=True)
    assert tuple(tl.shape) == (2, 1, pm.config.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
    for (jk, jv), (tk, tv) in zip(jpast, tpast):
        np.testing.assert_allclose(_np(tk), _np(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(_np(tv), _np(jv), atol=ATOL, rtol=0)
    more = np.array([[5, 6], [7, 1]], np.int64)
    jl2, _ = jm(Tensor(more), past=jpast, use_cache=True)
    tl2, tpast2 = pm(torch.from_numpy(more), past=tpast, use_cache=True)
    assert tpast2[0][0].shape[1] == IDS.shape[1] + 2
    np.testing.assert_allclose(_np(tl2), _np(jl2), atol=ATOL, rtol=0)
    # a past is consumed without use_cache too
    tl3 = pm(torch.from_numpy(more), past=tpast)
    np.testing.assert_allclose(_np(tl3), _np(jl2), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_decode_step_matches_jax_step_fn(models, interpret, name):
    """One step of ``build_decode_step`` over fixed-shape caches against the
    JAX ``step_fn`` with its Pallas kernels (interpret mode): logits and the
    appended cache rows."""
    jm, pm = models[name]
    s_total, pos = 10, IDS.shape[1]
    _, tpast = pm(torch.from_numpy(IDS), use_cache=True,
                  last_logits_only=True)
    caches = []
    for k, v in tpast:
        kc = torch.zeros((2, s_total) + tuple(k.shape[2:]))
        vc = torch.zeros_like(kc)
        kc[:, :pos], vc[:, :pos] = k, v
        caches.append((kc, vc))
    jcaches = tuple((jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
                    for k, v in caches)
    tok = np.array([7, 30], np.int64)
    jparams, jstep = jm.build_decode_step()
    jlogits, jnew = jstep(jparams, jnp.asarray(tok), jcaches, jnp.int32(pos))
    tparams, tstep = pm.build_decode_step()
    tlogits, tnew = tstep(tparams, torch.from_numpy(tok), caches, pos)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), atol=ATOL, rtol=0)
    assert tnew is caches                      # updated in place
    for (jk, jv), (tk, tv) in zip(jnew, caches):
        np.testing.assert_allclose(_np(tk), _np(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(_np(tv), _np(jv), atol=ATOL, rtol=0)


def test_decode_step_params_are_views_of_the_parameters(models):
    """GPT's q/k/v weights and biases are column slices of the packed
    projection, not copies."""
    _, pm = models["gpt"]
    params, _ = pm.build_decode_step()
    w = pm.gpt.layers[0].attn.qkv_proj.weight
    blk = params["blocks"][0]
    hidden = pm.config.hidden_size
    assert blk["wk"].data_ptr() == w.data_ptr() + hidden * w.element_size()
    assert blk["wk"].stride() == w.stride()
    assert params["lm_w"] is pm.gpt.embeddings.word_embeddings.weight


# ---------------------------------------------------------------------------
# tokens: the port's loops against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt", "llama"])
@pytest.mark.parametrize("route", ["interpret", "reference"])
def test_greedy_tokens_match_jax(models, name, route):
    jm, pm = models[name]
    keep = get_flags(["FLAGS_pallas_interpret"])
    set_flags({"FLAGS_pallas_interpret": route == "interpret"})
    try:
        jeager = _np(jm.generate(Tensor(IDS), max_new_tokens=8))
        jcomp = _np(jm.generate(Tensor(IDS), max_new_tokens=8,
                                _megakernel=True))
    finally:
        set_flags(keep)
    np.testing.assert_array_equal(jcomp, jeager)
    comp = tgen.decode_loop(pm, IDS, max_new_tokens=8)
    assert tgen.decode_stats == dict(loop="compiled", steps=7, host_reads=0,
                                     generated=8)
    eager = pm.generate(IDS, max_new_tokens=8)
    assert tgen.decode_stats["loop"] == "eager"
    np.testing.assert_array_equal(_np(comp), jcomp)
    np.testing.assert_array_equal(_np(eager), jeager)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_eos_early_exit_has_the_exact_stop_column(models, name):
    """The first greedy token as EOS (as the JAX test picks it): both of the
    port's loops stop where the JAX loops stop, with the same tokens."""
    jm, pm = models[name]
    ids = IDS[:1]
    first = int(_np(pm.generate(ids, max_new_tokens=1))[0, -1])
    jeager = _np(jm.generate(Tensor(ids), max_new_tokens=12,
                             eos_token_id=first))
    jcomp = _np(jm.generate(Tensor(ids), max_new_tokens=12,
                            eos_token_id=first, _megakernel=True))
    np.testing.assert_array_equal(jcomp, jeager)
    comp = tgen.decode_loop(pm, ids, max_new_tokens=12, eos_token_id=first)
    stats = dict(tgen.decode_stats)
    eager = pm.generate(ids, max_new_tokens=12, eos_token_id=first)
    np.testing.assert_array_equal(_np(comp), jeager)
    np.testing.assert_array_equal(_np(eager), jeager)
    assert jeager.shape[1] < ids.shape[1] + 12      # the exit actually cut
    # the stop was seen at the first poll (8 tokens) and read once more
    assert stats == dict(loop="compiled", steps=7, host_reads=2,
                         generated=jeager.shape[1] - ids.shape[1])


def test_eos_with_rows_stopping_apart(models):
    """Two rows, EOS met by one of them only, then by both: the width is
    the JAX loop's (the last row's first EOS), rows already finished hold
    at EOS."""
    _, pm = models["llama"]
    greedy = _np(tgen.decode_loop(pm, IDS, max_new_tokens=12))[:, 4:]
    for eos in sorted(set(greedy[0].tolist()) | set(greedy[1].tolist())):
        want_rows = []
        for row in greedy:
            hit = np.flatnonzero(row == eos)
            want_rows.append(None if hit.size == 0 else hit[0])
        got = _np(tgen.decode_loop(pm, IDS, max_new_tokens=12,
                                   eos_token_id=int(eos)))[:, 4:]
        eager = _np(pm.generate(IDS, max_new_tokens=12,
                                eos_token_id=int(eos)))[:, 4:]
        np.testing.assert_array_equal(got, eager)
        n = 12 if None in want_rows else max(want_rows) + 1
        assert got.shape[1] == n, eos
        for row, g, at in zip(greedy, got, want_rows):
            stop = n if at is None else at + 1
            np.testing.assert_array_equal(g[:stop], row[:stop])
            assert (g[stop:] == eos).all()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8),
    (0.8, 40, 0.95), (1.3, 3, 0.5)])
def test_sampler_picks_jax_tokens_given_jax_gumbel_noise(temperature, top_k,
                                                         top_p):
    rs = np.random.RandomState(int(temperature * 10) + top_k)
    logits = (rs.randn(6, 64) * 3).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        noise = np.asarray(jax.random.gumbel(key, logits.shape,
                                             jnp.float32))
        want = np.asarray(jgen._sample_logits(
            jnp.asarray(logits), key, "sampling", temperature, top_k, top_p))
        got = tgen._sample_logits(torch.from_numpy(logits), "sampling",
                                  temperature, top_k, top_p,
                                  noise=torch.tensor(noise))
        np.testing.assert_array_equal(got.numpy(), want)
    greedy = tgen._sample_logits(torch.from_numpy(logits), "greedy_search",
                                 temperature, top_k, top_p)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_gumbel_draw_keeps_masked_logits_out():
    """u is clamped away from 0 (``-log(-log(tiny))`` is finite), so a
    ``-inf`` logit plus the noise stays ``-inf`` and is never drawn."""
    g = torch.Generator().manual_seed(0)
    noise = tgen._gumbel((4, 1000), g, "cpu")
    assert torch.isfinite(noise).all()
    logits = torch.zeros(4, 1000)
    logits[:, 1:] = float("-inf")
    for _ in range(5):
        tok = tgen._sample_logits(logits, "sampling", 1.0, 0, 1.0, g)
        assert (tok == 0).all()


@pytest.mark.parametrize("eos", [None, "drawn"])
def test_compiled_equals_eager_sampling_and_advances_the_generator_alike(
        models, eos):
    _, pm = models["llama"]
    kw = dict(max_new_tokens=12, decode_strategy="sampling",
              temperature=0.9, top_k=8, top_p=0.95)
    if eos is not None:
        g = torch.Generator().manual_seed(7)
        kw["eos_token_id"] = int(_np(pm.generate(IDS, generator=g, **kw))[
            0, IDS.shape[1] + 2])
    ge, gc = (torch.Generator().manual_seed(123) for _ in range(2))
    for _ in range(2):        # back to back: the second call's draws too
        eager = pm.generate(IDS, generator=ge, **kw)
        comp = tgen.decode_loop(pm, IDS, generator=gc, **kw)
        np.testing.assert_array_equal(_np(comp), _np(eager))
        assert torch.equal(ge.get_state(), gc.get_state())
    # the model's own generator is the default
    state = pm.generator.get_state()
    a = pm.generate(IDS, **kw)
    pm.generator.set_state(state)
    b = tgen.decode_loop(pm, IDS, **kw)
    np.testing.assert_array_equal(_np(a), _np(b))


# ---------------------------------------------------------------------------
# the fallback reasons, and the device rule
# ---------------------------------------------------------------------------

def test_other_requests_take_the_eager_loop(models):
    """The JAX package's fallback reasons: an unknown strategy, no cache, or
    nothing to generate run the eager loop."""
    _, pm = models["llama"]
    assert tgen._megakernel_fallback_reason(
        pm, "greedy_search", 1, False, True, 4) is None
    assert tgen._megakernel_fallback_reason(
        pm, "contrastive", 1, False, True, 4) == "strategy:contrastive"
    assert tgen._megakernel_fallback_reason(
        pm, "greedy_search", 1, False, False, 4) == "no_kv_cache"
    out = tgen.decode_loop(pm, IDS, max_new_tokens=5, use_cache=False)
    assert tgen.decode_stats["loop"] == "eager"
    np.testing.assert_array_equal(
        _np(out), _np(tgen.decode_loop(pm, IDS, max_new_tokens=5)))
    assert _np(tgen.decode_loop(pm, IDS, max_new_tokens=0)).shape == (2, 4)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig(**_LLAMA))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForPretraining(gpt_config("tiny"))
    sig = inspect.signature(tgen.generate).parameters
    assert "device" not in sig          # generate runs where the model is


def test_max_length_and_the_position_table_bound_the_tokens(models):
    _, pm = models["llama"]
    out = tgen.decode_loop(pm, IDS, max_length=7)
    assert _np(out).shape == (2, 7)
    room = _LLAMA["max_position_embeddings"] - IDS.shape[1]
    assert _np(pm.generate(IDS, max_new_tokens=500)).shape[1] == 64
    assert tgen.decode_stats["generated"] == room
    with pytest.raises(ValueError, match="already reaches"):
        pm.generate(np.zeros((1, 64), np.int64))
