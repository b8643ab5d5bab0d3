"""Eager paged ``generate``, beam search and ``seq2seq_generate`` of the
PyTorch port, held against the JAX package on the CPU (and beam search
against ``transformers`` too).  Tiny GPT and LLaMA weights (GQA 4/2, the
sizes of ``tests/test_torch_decode_loop.py``) are made by ``paddle_tpu``
and carried into the port; other inputs come from numpy seeds.

Tolerances:
* ``paged_attention_ref`` against the JAX reference: fp32 within 2e-5
  (the same fp32 einsums and softmax summed in other orders by XLA and
  torch), bf16 within 2e-2 (both round once to bf16 from fp32 sums that
  differ in order: one bf16 step of outputs below 4).  A zero-length row
  is exactly 0.
* ``PagedKVCache``: pools, tables and lengths EQUAL to the JAX cache's
  (pure copies).
* Tokens IDENTICAL: paged greedy against the JAX package's paged and
  dense ``generate``; beam search against ``paddle_tpu``'s
  ``_beam_search`` and against ``transformers``' beam search;
  ``seq2seq_generate`` against JAX's over the same weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import paged_attention as jpa

from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                     LlamaConfig, LlamaForCausalLM,
                                     gpt_config, load_paddle_tpu_state)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import paged_attention as tpa

_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
_LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=64,
              max_position_embeddings=64)
IDS = np.array([[3, 9, 17, 25], [4, 8, 15, 16]], np.int64)
REF_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    if isinstance(x, Tensor):
        x = x._data
    return np.asarray(x)


def _jax_tokens(jm, ids, **kw):
    return _np(jm.generate(Tensor(ids), **kw))


# ---------------------------------------------------------------------------
# paged_attention_ref
# ---------------------------------------------------------------------------

def _paged_case(nh, nkv, dtype, seed=0, ps=4, hd=16):
    """Ragged lengths with a zero-length row; table slots past a row's
    pages point at page 0, whose bytes are live data of another row."""
    rs = np.random.RandomState(seed)
    lengths = np.array([5, 0, 13, 1, 16], np.int32)
    ppseq = 4
    pages = rs.permutation(3 * len(lengths))
    tables = np.zeros((len(lengths), ppseq), np.int32)
    at = 0
    for i, n in enumerate(lengths):
        k = -(-int(n) // ps)
        tables[i, :k] = pages[at:at + k]
        at += k
    shape = (nkv, 3 * len(lengths), ps, hd)
    kp, vp = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    q = rs.randn(len(lengths), nh, hd).astype(np.float32)
    return q, kp, vp, lengths, tables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_paged_attention_ref_matches_jax(dtype, heads):
    q, kp, vp, lengths, tables = _paged_case(*heads, dtype, seed=sum(heads))
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(tdt) for a in (q, kp, vp)]
    got = tpa.paged_attention(*args, torch.from_numpy(lengths),
                              torch.from_numpy(tables))
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    import jax.numpy as jnp
    jargs = [jnp.asarray(a, dtype) for a in (q, kp, vp)]
    want = jpa.paged_attention_ref(*jargs, jnp.asarray(lengths),
                                   jnp.asarray(tables))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=REF_TOL[dtype], rtol=0)
    assert (_np(got)[1] == 0).all()          # the zero-length row


def test_paged_attention_cpu_grad_takes_the_plain_version():
    """A CPU input that needs a gradient goes through the plain version,
    which autograd differentiates (the JAX route's differentiable
    reference)."""
    q, kp, vp, lengths, tables = _paged_case(4, 2, "float32")
    tq = torch.from_numpy(q).requires_grad_()
    out = tpa.paged_attention(tq, torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(lengths),
                              torch.from_numpy(tables))
    out.square().sum().backward()
    assert torch.isfinite(tq.grad).all() and tq.grad.abs().sum() > 0
    assert (tq.grad[1] == 0).all()           # the zero-length row


def test_paged_attention_off_the_cpu_launches_or_raises(monkeypatch):
    """Tensors that are not on the CPU never take the plain version: an
    input needing a gradient raises (the kernel has no backward), another
    device raises, and nothing builds a pool on a card that is absent."""
    before = tpa.launches
    q, kp, vp, lengths, tables = (torch.empty(s, device="meta", dtype=d)
                                  for s, d in (((2, 4, 16), torch.float32),
                                               ((2, 8, 4, 16), torch.float32),
                                               ((2, 8, 4, 16), torch.float32),
                                               ((2,), torch.int32),
                                               ((2, 4), torch.int32)))
    with pytest.raises(RuntimeError, match="no backward"):
        tpa.paged_attention(q.requires_grad_(), kp, vp, lengths, tables)
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_attention(q.detach(), kp, vp, lengths, tables)
    assert tpa.launches == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tpa.PagedKVCache(8, 4, 2, 16, 2),
                 lambda: tpa.PagedKVCache(8, 4, 2, 16, 2, device="cuda"),
                 lambda: tpa.build_paged_caches(2, 2, 8, 2, 16),
                 lambda: tgen.seq2seq_generate(lambda ids: None, 0, 1, 2,
                                               None, 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# PagedKVCache
# ---------------------------------------------------------------------------

def _cache_script(mod, to, op, device_kw):
    """One scenario on either package's cache: three sequences filled by
    ``op``, one freed and its pages reused.  Returns (k pool, v pool,
    lengths, tables) as numpy."""
    rs = np.random.RandomState(7)
    nkv, hd, ps = 2, 8, 4
    cache = mod.PagedKVCache(num_pages=12, page_size=ps, num_kv_heads=nkv,
                             head_dim=hd, max_pages_per_seq=4, **device_kw)
    lens = {"a": 7, "b": 4, "c": 9}
    data = {s: (rs.randn(n + 3, nkv, hd).astype(np.float32),
                rs.randn(n + 3, nkv, hd).astype(np.float32))
            for s, n in lens.items()}
    for s in lens:
        cache.allocate(s)
    if op == "prefill":
        for s, n in lens.items():
            cache.prefill(s, to(data[s][0][:n]), to(data[s][1][:n]))
    elif op == "append":
        for s, n in lens.items():
            for t in range(n):
                cache.append(s, to(data[s][0][t]), to(data[s][1][t]))
    else:                               # prefill 2, then batched appends
        for s in lens:
            cache.prefill(s, to(data[s][0][:2]), to(data[s][1][:2]))
        for t in range(2, 6):
            cache.append_batch(list(lens), to(np.stack(
                [data[s][0][t] for s in lens])), to(np.stack(
                    [data[s][1][t] for s in lens])))
    cache.free("b")
    cache.allocate("d")
    cache.prefill("d", to(data["a"][0][:6]), to(data["a"][1][:6]))
    cache.append_batch(["a", "c", "d"],
                       to(np.stack([data["c"][0][-1]] * 3)),
                       to(np.stack([data["c"][1][-1]] * 3)))
    lengths, tables = cache.batch_tables(["a", "c", "d"])
    return (_np(cache.k_pages), _np(cache.v_pages), _np(lengths),
            _np(tables))


@pytest.mark.parametrize("op", ["prefill", "append", "append_batch"])
def test_paged_cache_matches_jax(op):
    got = _cache_script(tpa, torch.from_numpy, op, {"device": "cpu"})
    want = _cache_script(jpa, Tensor, op, {})
    for g, w, what in zip(got, want, ("k_pages", "v_pages", "lengths",
                                      "tables")):
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("mod", ["torch", "jax"])
def test_paged_cache_errors_match_jax(mod):
    """The same errors in the same places: a pool run dry, a sequence
    past its table, a sequence allocated twice."""
    m, to, kw = (tpa, torch.from_numpy, {"device": "cpu"}) \
        if mod == "torch" else (jpa, Tensor, {})
    rs = np.random.RandomState(2)

    def tok():
        return (to(rs.randn(1, 4).astype(np.float32)),
                to(rs.randn(1, 4).astype(np.float32)))

    cache = m.PagedKVCache(num_pages=2, page_size=2, num_kv_heads=1,
                           head_dim=4, max_pages_per_seq=2, **kw)
    cache.allocate("x")
    for _ in range(4):
        cache.append("x", *tok())
    cache.allocate("y")
    with pytest.raises(RuntimeError, match="KV page pool exhausted"):
        cache.append("y", *tok())
    cache.free("x")
    for _ in range(4):
        cache.append("y", *tok())
    assert cache.length("y") == 4
    with pytest.raises(RuntimeError,
                       match="'y' exceeds max_pages_per_seq"):
        cache.append("y", *tok())
    with pytest.raises(ValueError, match="already allocated"):
        cache.allocate("y")


# ---------------------------------------------------------------------------
# paged greedy generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt", "llama"])
@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
def test_paged_greedy_tokens_match_jax(models, name, eos):
    jm, pm = models[name]
    kw = dict(max_new_tokens=10)
    if eos:
        # a token of row 0's greedy run: the rows stop apart, or at the end
        first = _np(pm.generate(IDS, max_new_tokens=3))
        kw["eos_token_id"] = int(first[0, -1])
    jpaged = _jax_tokens(jm, IDS, use_paged_cache=True, **kw)
    jdense = _jax_tokens(jm, IDS, **kw)
    np.testing.assert_array_equal(jpaged, jdense)
    got = pm.generate(IDS, use_paged_cache=True, **kw)
    stats = dict(tgen.decode_stats)
    np.testing.assert_array_equal(_np(got), jpaged)
    assert stats["loop"] == "paged"
    assert stats["generated"] == jpaged.shape[1] - IDS.shape[1]
    assert stats["table_copies"] == 0        # the CPU copies nothing
    # decode_loop takes the eager paged loop, as in the JAX package
    comp = tgen.decode_loop(pm, IDS, use_paged_cache=True, **kw)
    assert tgen.decode_stats["loop"] == "paged"
    np.testing.assert_array_equal(_np(comp), jpaged)


def test_paged_prefill_leaves_the_jax_pools(models):
    """``_to_paged`` on the same dense cache fills every layer's pools as
    the JAX conversion does (one write per pool per row here, page by
    page there)."""
    jm, pm = models["llama"]
    _, jpast = jm(Tensor(IDS), use_cache=True)
    _, tpast = pm(torch.from_numpy(IDS), use_cache=True)
    jviews = jgen._to_paged(jpast, 2, 11)
    tviews = tgen._to_paged(tpast, 2, 11)
    for jv, tv in zip(jviews, tviews):
        np.testing.assert_allclose(_np(tv.cache.k_pages),
                                   _np(jv.cache.k_pages), atol=2e-5, rtol=0)
        np.testing.assert_allclose(_np(tv.cache.v_pages),
                                   _np(jv.cache.v_pages), atol=2e-5, rtol=0)
        np.testing.assert_array_equal(tv.lengths_np(), jv.lengths_np())
        for got, want in zip(tv.cache.batch_tables([0, 1]),
                             jv.cache.batch_tables([0, 1])):
            np.testing.assert_array_equal(_np(got), _np(want))


def test_paged_step_logits_match_the_dense_step(models):
    """One paged decode step (LLaMA: per-row rope at each row's length)
    against one dense cached step: logits within 2e-5."""
    _, pm = models["llama"]
    logits, past = pm(torch.from_numpy(IDS), use_cache=True)
    tok = logits[:, -1].argmax(-1)[:, None]
    dense, _ = pm(tok, past=past, use_cache=True)
    paged, views = pm(tok, past=tgen._to_paged(past, 2, 8), use_cache=True)
    np.testing.assert_allclose(_np(paged), _np(dense), atol=2e-5, rtol=0)
    assert views[0].lengths_np().tolist() == [5, 5]


def test_llama_ragged_paged_step_matches_jax(models):
    """Rows of different lengths: each row is rotated at its own position
    and attends to its own pages; logits and the rows' new lengths equal
    the JAX model's over the same ragged views (2e-5)."""
    jm, pm = models["llama"]
    _, jpast = jm(Tensor(IDS), use_cache=True)
    _, tpast = pm(torch.from_numpy(IDS), use_cache=True)
    jviews = _ragged_views(jpa, Tensor, jpast, {})
    tviews = _ragged_views(tpa, torch.from_numpy, tpast, {"device": "cpu"})
    tok = np.array([[7], [11]], np.int64)
    jl, jv = jm(Tensor(tok), past=jviews, use_cache=True)
    tl, tv = pm(torch.from_numpy(tok), past=tviews, use_cache=True)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=2e-5, rtol=0)
    assert tv[0].lengths_np().tolist() == jv[0].lengths_np().tolist() \
        == [5, 3]


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

BEAM_CASES = {
    # name, num_beams, eos, length_penalty, use_cache, pad_token_id
    "gpt-nb2": ("gpt", 2, False, 1.0, True, None),
    "gpt-nb3-eos": ("gpt", 3, True, 1.0, True, None),
    "gpt-nb3-eos-lp-nocache": ("gpt", 3, True, 0.7, False, None),
    "gpt-nb2-eos-lp2-pad": ("gpt", 2, True, 2.0, True, 0),
    "llama-nb2-eos-lp": ("llama", 2, True, 1.3, True, None),
    "llama-nb3-lp": ("llama", 3, False, 0.7, True, None),
    "llama-nb3-eos-nocache": ("llama", 3, True, 1.0, False, None),
    "llama-nb2-nocache": ("llama", 2, False, 1.0, False, None),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_tokens_match_jax(models, case):
    name, nb, eos, lp, cache, pad = BEAM_CASES[case]
    jm, pm = models[name]
    kw = dict(max_new_tokens=7, num_beams=nb, length_penalty=lp,
              use_cache=cache, decode_strategy="beam_search")
    if pad is not None:
        kw["pad_token_id"] = pad
    if eos:
        # a token the beams meet: the second token of row 1's greedy run
        kw["eos_token_id"] = int(_np(pm.generate(IDS, max_new_tokens=2))
                                 [1, -1])
    want = _jax_tokens(jm, IDS, **kw)
    got = pm.generate(IDS, **kw)
    stats = dict(tgen.decode_stats)
    np.testing.assert_array_equal(_np(got), want)
    assert stats["loop"] == "beam" and len(stats["scores"]) == IDS.shape[0]
    assert stats["host_reads"] == stats["steps"] + 1 or eos


def test_beam_with_and_without_cache_and_one_beam(models):
    """The cache changes no beam token; ``num_beams=1`` is greedy; the
    compiled entry takes the beam loop too."""
    _, pm = models["gpt"]
    a = pm.generate(IDS, max_new_tokens=6, num_beams=3)
    b = pm.generate(IDS, max_new_tokens=6, num_beams=3, use_cache=False)
    c = tgen.decode_loop(pm, IDS, max_new_tokens=6, num_beams=3)
    assert tgen.decode_stats["loop"] == "beam"
    np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(a), _np(c))
    np.testing.assert_array_equal(
        _np(pm.generate(IDS, max_new_tokens=6, num_beams=1)),
        _np(pm.generate(IDS, max_new_tokens=6)))


def test_beam_scores_are_the_hypotheses_log_probs(models):
    """Each returned hypothesis's carried score equals its summed
    log-probs from one dense forward over it, over len ** penalty (fp32
    log-softmax on both sides: 1e-5)."""
    _, pm = models["llama"]
    lp, new = 0.8, 6
    out = pm.generate(IDS, max_new_tokens=new, num_beams=3,
                      length_penalty=lp)
    scores = tgen.decode_stats["scores"]
    logp = torch.log_softmax(pm(out).float(), dim=-1)
    s = IDS.shape[1]
    for b in range(IDS.shape[0]):
        toks = out[b, s:]
        total = logp[b, s - 1:-1].gather(-1, toks[:, None]).sum().item()
        assert total / out.shape[1] ** lp == pytest.approx(scores[b],
                                                           abs=1e-5)


@pytest.mark.parametrize("eos", [None, 17], ids=["no_eos", "eos17"])
def test_beam_search_matches_transformers(eos):
    """The external oracle, as ``tests/test_generation.py`` holds the JAX
    package: a transformers GPT-2 (local config, random weights)
    converted to ``paddle_tpu``, carried into the port, generates
    transformers' beams token for token."""
    transformers = pytest.importorskip("transformers")
    from paddle_tpu.models.convert import gpt2_from_hf
    torch.manual_seed(0)
    hf_cfg = transformers.GPT2Config(
        vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        attn_implementation="eager", eos_token_id=None, bos_token_id=None)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    jm = gpt2_from_hf(hf)
    pm = GPTForPretraining(GPTConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
        max_position_embeddings=64, **_NO_DROPOUT), device="cpu")
    _carry(jm, pm)
    ids = np.array([[3, 9, 30, 4], [12, 40, 2, 5]], np.int64)
    with torch.no_grad():
        want = hf.generate(torch.tensor(ids), max_new_tokens=8,
                           num_beams=3, do_sample=False, eos_token_id=eos,
                           pad_token_id=0 if eos is None else eos).numpy()
    got = _np(pm.generate(ids, max_new_tokens=8,
                          decode_strategy="beam_search", num_beams=3,
                          eos_token_id=eos))
    np.testing.assert_array_equal(got[:, :want.shape[1]], want)
    # nothing but padding past transformers' width
    assert got.shape[1] == want.shape[1] or \
        (got[:, want.shape[1]:] == eos).all(), got


# ---------------------------------------------------------------------------
# seq2seq_generate
# ---------------------------------------------------------------------------

SEQ2SEQ_CASES = {
    # num_beams, eos, forced_eos, length_penalty
    "greedy": (1, None, None, 1.0),
    "greedy-eos-forced": (1, 5, 7, 1.0),
    "beam3-forced": (3, None, 7, 1.0),
    "beam2-eos-lp": (2, 5, None, 0.6),
}


@pytest.mark.parametrize("case", list(SEQ2SEQ_CASES))
def test_seq2seq_generate_matches_jax(models, case):
    """Over the same decode step (a causal LM over the decoder ids) the
    port's loop returns JAX's tokens."""
    nb, eos, forced, lp = SEQ2SEQ_CASES[case]
    jm, pm = models["llama"]
    if eos is not None:           # a token the decoder meets
        eos = int(_np(pm.generate(np.array([[1]]), max_new_tokens=3))
                  [0, -1])
    kw = dict(start_token_id=1, batch=2, max_new_tokens=5, eos_token_id=eos,
              pad_token_id=0, num_beams=nb, length_penalty=lp,
              forced_eos_token_id=forced, max_positions=64)
    want = _np(jgen.seq2seq_generate(lambda ids: jm(ids), **kw))
    got = tgen.seq2seq_generate(lambda ids: pm(ids), device="cpu", **kw)
    np.testing.assert_array_equal(_np(got), want)
    if forced is not None and nb == 1 and eos is None:
        assert (want[:, -1] == forced).all()


# ---------------------------------------------------------------------------
# the JAX package's errors
# ---------------------------------------------------------------------------

class _NoPagedGPT(GPTForPretraining):
    supports_paged_cache = False


class _JaxNoPagedGPT(JaxGPT):
    supports_paged_cache = False


def _ragged_views(mod, to, past, kw):
    views = mod.build_paged_caches(len(past), 2, 8, past[0][0].shape[2],
                                   past[0][0].shape[3], **kw)
    for view, (k, v) in zip(views, past):
        view.cache.prefill(0, to(_np(k)[0]), to(_np(v)[0]))
        view.cache.prefill(1, to(_np(k)[1, :2]), to(_np(v)[1, :2]))
    return views


@pytest.mark.parametrize("mod", ["torch", "jax"])
def test_errors_match_jax(models, mod):
    jm, pm = models["gpt"]
    m = pm if mod == "torch" else jm
    ids = IDS if mod == "torch" else Tensor(IDS)
    with pytest.raises(ValueError, match="page pool does not support"):
        m.generate(ids, max_new_tokens=2, num_beams=2, use_paged_cache=True)
    with pytest.raises(NotImplementedError, match="beam-sampling"):
        m.generate(ids, max_new_tokens=2, num_beams=2,
                   decode_strategy="sampling")
    if mod == "torch":
        other = _NoPagedGPT(gpt_config("tiny", **_NO_DROPOUT), device="cpu")
        ragged = _ragged_views(tpa, torch.from_numpy,
                               pm(torch.from_numpy(IDS), use_cache=True)[1],
                               {"device": "cpu"})
        step = torch.from_numpy(IDS[:, :1])
        seq2seq = tgen.seq2seq_generate
        s2s_kw = {"device": "cpu"}
    else:
        other = _JaxNoPagedGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
        ragged = _ragged_views(jpa, Tensor,
                               jm(Tensor(IDS), use_cache=True)[1], {})
        step = Tensor(IDS[:, :1])
        seq2seq = jgen.seq2seq_generate
        s2s_kw = {}
    with pytest.raises(ValueError, match="does not support use_paged_cache"):
        other.generate(ids, max_new_tokens=2, use_paged_cache=True)
    with pytest.raises(ValueError, match="uniform lengths"):
        m(step, past=ragged, use_cache=True)
    with pytest.raises(ValueError, match="exceeds max_position_embeddings"):
        seq2seq(lambda ids: None, 1, 1, 8, None, 0, max_positions=8,
                **s2s_kw)
