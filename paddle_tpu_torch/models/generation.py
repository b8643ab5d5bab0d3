"""Autoregressive generation; counterpart of
``paddle_tpu/models/generation.py``.

Two decode loops share this module, as in the JAX package:

* the **eager loop** (:func:`generate`) — a prefill over the prompt,
  then one cache-aware dense forward per token (attention at ``sq = 1``
  through K1 with ``q_offset``), writing into a preallocated token
  buffer, with the ``finished.all()`` host read hoisted to every
  ``EAGER_FINISHED_SYNC_EVERY`` tokens and the exact stop column rebuilt
  afterwards;
* the **compiled loop** (:func:`decode_loop`, ``generate(...,
  _megakernel=True)``) — the same prefill, then the model's
  ``build_decode_step`` body over preallocated fixed-shape caches,
  updated in place: per layer the decode kernels K6a (rope + QKV), K6b
  (attend + cache append) and K6c (norm + MLP) of ``ops.fused_decode``.
  Sampling and EOS stay on the device; the position is a host int the
  loop knows, so the only host reads are the hoisted ``finished`` poll
  and, with an EOS, one read of the generated count.  The JAX package
  runs this loop as one jitted ``lax.while_loop``; PyTorch runs eagerly,
  so here it is a host loop that launches the same kernels (a CUDA graph
  over it is later work).  Its output equals the JAX program's
  ``tokens[:, :s_prompt + n]``, ``n`` included; it skips the last step,
  whose logits the JAX program computes and discards.

Both loops draw from one sampler, :func:`_sample_logits` (greedy argmax,
or temperature, top-k, top-p in the JAX order, then a Gumbel-max draw
from a ``torch.Generator``: ``jax.random.categorical`` is ``argmax(logits
+ gumbel)``), so with the same generator state they give the same tokens
and advance the generator alike.  ``generator=`` defaults to the
model's own.

The eager loop also runs over a **paged cache** (``use_paged_cache=
True``): the prefill's dense cache is copied into one
``ops.paged_attention.PagedKVCache`` per layer and each step appends to
the pages and attends through ``paged_attention`` (K9's counterpart on
CUDA); the page tables stay on the host, and a step copies its write
indices and tables to the card once for all layers
(``decode_stats["table_copies"]``).  ``num_beams > 1`` runs
:func:`_beam_search`, HF-semantics beam search over the dense cache, and
:func:`seq2seq_generate` the encoder-decoder loop over a caller's
``decode_step``.  The compiled loop emits the reference's observability
records: a ``decode_loop`` span and event a call (a ``decode_loop``
event with the ``fallback`` reason when a request takes the eager loop),
and a ``decode_compile`` span around the first call of a signature; the
counts of the last call are in :data:`decode_stats`.

:func:`build_ragged_decode_step` is the serving engine's batched step
over paged KV pools, for GPT and LLaMA, and :func:`build_fused_window_step`
runs up to ``max_window`` of its decode iterations with one host read;
both sample with :func:`serving_sample`.
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Optional

import numpy as np
import torch

from ..device import default_device
from ..observability import events, tracing
from ..ops import fused_decode as _fd
from ..ops import paged_attention as _pa
from ..ops.ragged_paged_attention import (append_positions,
                                          ragged_paged_attention)

__all__ = ["generate", "decode_loop", "seq2seq_generate",
           "build_ragged_decode_step", "build_fused_window_step",
           "serving_sample", "decode_stats", "EAGER_FINISHED_SYNC_EVERY"]

_GREEDY = ("greedy_search", "greedy")
# the default of the JAX package's FLAGS_eager_finished_sync_every
# (paddle_tpu/flags.py); FLAGS_megakernel_decode's default, off, is
# generate's default loop
EAGER_FINISHED_SYNC_EVERY = 8

# the last generate call: which loop ran ("eager", "paged", "compiled" or
# "beam"), the model steps it took after the prefill, the host reads of
# device values it made (the hoisted finished polls and the stop-column
# read; the beam loop's one read per step), and the tokens it generated
# per row; "paged" adds the page-table copies to the card, "beam" the
# score of each row's returned hypothesis
decode_stats = {}


def _record(**stats) -> None:
    decode_stats.clear()
    decode_stats.update(stats)


def _gumbel(shape, generator, device):
    """``jax.random.gumbel``'s draw: ``-log(-log(u))`` with ``u`` uniform
    in ``[tiny, 1)`` (a ``-inf`` logit plus this noise stays ``-inf``)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample_logits(logits_row, decode_strategy, temperature, top_k, top_p,
                   generator=None, noise=None):
    """One next-token choice from ``[B, V]`` logits, on their device.
    Greedy: argmax.  Otherwise fp32 logits / temperature, top-k, then
    top-p (the smallest set whose mass reaches ``top_p``) as the JAX
    sampler filters, and ``argmax(logits + g)`` with Gumbel noise ``g``
    drawn from ``generator`` (or given as ``noise``)."""
    if decode_strategy in _GREEDY:
        return torch.argmax(logits_row, dim=-1)
    logits = logits_row.float()
    if temperature and temperature != 1.0:
        logits = logits / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p and top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        idx = (cum < top_p).sum(dim=-1, keepdim=True) \
            .clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_l, -1, idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    if noise is None:
        noise = _gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise, dim=-1)


def _megakernel_fallback_reason(model, decode_strategy, num_beams,
                                use_paged_cache, supports_cache,
                                max_new_tokens) -> Optional[str]:
    """None when the compiled loop can run this request; else the reason
    the eager loop runs instead (the JAX package's reasons)."""
    if num_beams > 1:
        return "beam_search"
    if decode_strategy not in _GREEDY + ("sampling",):
        return f"strategy:{decode_strategy}"
    if use_paged_cache:
        return "paged_cache"
    if not supports_cache:
        return "no_kv_cache"
    if not hasattr(model, "build_decode_step"):
        return "no_decode_step_builder"
    if int(max_new_tokens) <= 0:
        return "nothing_to_generate"
    return None


def _generated_count(tokens, s_prompt, n_run, eos_token_id):
    """The JAX loop's ``n``: it stops right after the token that finished
    the last row (each row's first EOS), else after ``n_run`` tokens."""
    hit = tokens[:, s_prompt:s_prompt + n_run] == eos_token_id
    first = hit.to(torch.int32).argmax(dim=1)
    return int(torch.where(hit.any(dim=1).all(), first.max() + 1,
                           torch.tensor(n_run, device=tokens.device)))


def _compiled_decode(model, ids, max_new, strategy, temperature, top_k,
                     top_p, eos_token_id, last_only, generator):
    """Prefill once, then the model's decode step over preallocated
    caches and token buffer, all updated in place; sampling and EOS on
    the device.  The first call with a signature runs its token loop
    inside a ``decode_compile`` span, as the reference spans the first
    call of each signature's program (here the loop's first launches of
    the decode kernels)."""
    kw = {"last_logits_only": True} if last_only else {}
    logits, past = model(ids, use_cache=True, **kw)
    params, step = model.build_decode_step()
    logits = logits[:, -1, :]
    b, s_prompt = ids.shape
    s_total = s_prompt + max_new
    tokens = ids.new_zeros((b, s_total))
    tokens[:, :s_prompt] = ids
    caches = []
    for k, v in past:
        kc = k.new_zeros((b, s_total) + tuple(k.shape[2:]))
        vc = v.new_zeros((b, s_total) + tuple(v.shape[2:]))
        kc[:, :s_prompt] = k
        vc[:, :s_prompt] = v
        caches.append((kc, vc))
    del past
    seen = model.__dict__.setdefault("_decode_signatures", set())
    ckey = (tuple(ids.shape), str(ids.dtype), int(max_new), str(strategy),
            float(temperature or 1.0), int(top_k or 0),
            float(top_p or 1.0),
            None if eos_token_id is None else int(eos_token_id),
            tuple((tuple(k.shape), str(k.dtype)) for k, _ in caches))
    span = contextlib.nullcontext() if ckey in seen else tracing.trace_span(
        "decode_compile", attrs={"batch": int(b), "prompt_len": int(s_prompt),
                                 "max_new_tokens": int(max_new)})
    seen.add(ckey)
    finished = torch.zeros(b, dtype=torch.bool, device=ids.device)
    sync = EAGER_FINISHED_SYNC_EVERY
    reads = steps = 0
    n_run = max_new
    with span:
        for i in range(max_new):
            nxt = _sample_logits(logits, strategy, temperature, top_k, top_p,
                                 generator)
            if eos_token_id is not None:
                nxt = torch.where(finished, eos_token_id, nxt)
                finished |= nxt == eos_token_id
            tokens[:, s_prompt + i] = nxt
            if i == max_new - 1:
                break
            if eos_token_id is not None and i % sync == sync - 1:
                reads += 1
                if bool(finished.all()):        # the hoisted poll
                    n_run = i + 1
                    break
            logits, _ = step(params, nxt, caches, s_prompt + i)
            steps += 1
    n = n_run
    if eos_token_id is not None:
        n = _generated_count(tokens, s_prompt, n_run, eos_token_id)
        reads += 1
    _record(loop="compiled", steps=steps, host_reads=reads, generated=n)
    return tokens[:, :s_prompt + n]


def _to_paged(past, batch, max_total):
    """Copy a dense prefill cache (per-layer (k, v) of ``[B, S, nkv, hd]``)
    into per-layer page pools + views, on the cache's device."""
    k0 = past[0][0]
    views = _pa.build_paged_caches(len(past), batch, max_total,
                                   k0.shape[2], k0.shape[3], dtype=k0.dtype,
                                   device=k0.device)
    for view, (k, v) in zip(views, past):
        for b in range(batch):
            view.cache.prefill(b, k[b], v[b])
    return views


def _eager_decode(model, ids, max_new, strategy, temperature, top_k, top_p,
                  eos_token_id, supports_cache, last_only, generator, paged):
    """One model call per token over a preallocated token buffer; the
    ``finished.all()`` read hoisted to every ``EAGER_FINISHED_SYNC_EVERY``
    tokens, the exact stop column rebuilt from the buffer.  With ``paged``
    (and a cache) the steps run over page pools instead of the dense
    cache."""
    past = None
    b, s_prompt = ids.shape
    paged = paged and supports_cache
    copies = _pa.table_copies
    if supports_cache:
        kw = {"last_logits_only": True} if last_only else {}
        logits, past = model(ids, use_cache=True, **kw)
        if paged:
            if not getattr(model, "supports_paged_cache", False):
                raise ValueError(
                    f"{type(model).__name__} does not support "
                    "use_paged_cache=True (its attention has no "
                    "PagedLayerView dispatch)")
            past = _to_paged(past, b, s_prompt + max_new)
    else:
        logits = model(ids)
    buf = ids.new_zeros((b, s_prompt + max_new))
    buf[:, :s_prompt] = ids
    finished = torch.zeros(b, dtype=torch.bool, device=ids.device)
    cur = s_prompt
    sync = EAGER_FINISHED_SYNC_EVERY
    reads = steps = 0
    stopped = False
    for it in range(max_new):
        nxt = _sample_logits(logits[:, -1, :], strategy, temperature, top_k,
                             top_p, generator)
        if eos_token_id is not None:
            nxt = torch.where(finished, eos_token_id, nxt)
            finished |= nxt == eos_token_id
        buf[:, cur] = nxt
        cur += 1
        if eos_token_id is not None and (it == max_new - 1
                                         or it % sync == sync - 1):
            reads += 1
            if bool(finished.all()):
                stopped = True
                break
        if it < max_new - 1:
            if supports_cache:
                logits, past = model(buf[:, cur - 1:cur], past=past,
                                     use_cache=True)
            else:
                logits = model(buf[:, :cur])
            steps += 1
    if stopped:
        # every row finished at its first EOS; the loop would have broken
        # right after the last row did — the columns past that are the
        # EOS padding the hoisted read let through
        cur = s_prompt + _generated_count(buf, s_prompt, cur - s_prompt,
                                          eos_token_id)
        reads += 1
    _record(loop="paged" if paged else "eager", steps=steps,
            host_reads=reads, generated=cur - s_prompt)
    if paged:
        decode_stats["table_copies"] = _pa.table_copies - copies
    return buf[:, :cur]


def _reorder_past(past, beam_idx):
    """Reorder a dense per-layer (k, v) cache along the batch axis: the
    beam permutation after each step."""
    return [(k.index_select(0, beam_idx), v.index_select(0, beam_idx))
            for k, v in past]


def _beam_search(model, arr, max_new_tokens, num_beams, length_penalty,
                 eos_token_id, supports_cache, last_only,
                 pad_token_id=None, forced_eos_token_id=None):
    """HF-semantics beam search (transformers' BeamSearchScorer, as the
    JAX package has it): per-batch hypotheses scored sum_logprobs /
    len**length_penalty, 2*num_beams candidates a step so eos candidates
    never starve the live set, dense cache rows permuted by the chosen
    beams.  ``model`` is a model or a callable ``ids -> logits`` (the
    decode step of :func:`seq2seq_generate`); ``arr [B, S]`` lies where it
    runs.  The beams' tokens stay on the host; each step makes one host
    read (the candidates' scores and indices)."""
    dev = arr.device
    B, s_prompt = arr.shape
    nb = int(num_beams)
    max_new = int(max_new_tokens)
    # each row becomes nb beams; the first is live, the rest at -1e9, so the
    # first step picks nb distinct continuations of the prompt
    arr_np = np.repeat(arr.cpu().numpy(), nb, axis=0)
    beam_scores = torch.full((B, nb), -1e9, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0
    hyps = [[] for _ in range(B)]      # (score, token array)
    done = [False] * B                 # pool frozen (HF is_done)
    reads = steps = 0

    past = None
    ids = arr.repeat_interleave(nb, dim=0)
    if supports_cache:
        kw = {"last_logits_only": True} if last_only else {}
        logits, past = model(ids, use_cache=True, **kw)
    else:
        logits = model(ids)

    for it in range(max_new):
        logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
        V = logp.shape[-1]
        if forced_eos_token_id is not None and it == max_new - 1:
            # HF ForcedEOSTokenLogitsProcessor: the last slot can only be
            # eos, at logp 0
            logp = torch.full_like(logp, -1e9)
            logp[:, int(forced_eos_token_id)] = 0.0
        scores = (beam_scores.reshape(B * nb, 1) + logp).reshape(B, nb * V)
        # jax.lax.top_k puts the lower index first among equal scores; a
        # stable descending sort does too (torch.topk promises no order)
        top_s, top_i = torch.sort(scores, dim=-1, descending=True,
                                  stable=True)
        top = torch.cat([top_s[:, :2 * nb].double(),
                         top_i[:, :2 * nb].double()], dim=1).cpu().numpy()
        reads += 1
        top_s, top_i = top[:, :2 * nb], top[:, 2 * nb:].astype(np.int64)
        beam_idx = np.zeros((B, nb), np.int64)
        beam_tok = np.zeros((B, nb), np.int64)
        new_scores = np.zeros((B, nb), np.float32)
        for b in range(B):
            if done[b]:
                beam_idx[b, :] = b * nb
                new_scores[b, :] = -1e9
                continue
            live = 0
            for rank, (sc, i) in enumerate(zip(top_s[b], top_i[b])):
                src, tok = divmod(int(i), V)
                if eos_token_id is not None and tok == eos_token_id:
                    if rank >= nb:
                        # an eos candidate outside the top num_beams never
                        # forms a hypothesis
                        continue
                    seq = arr_np[b * nb + src]
                    # normalised by the stored length: prompt included,
                    # the appended eos not
                    hyps[b].append(
                        (float(sc) / (seq.shape[0] ** length_penalty),
                         np.concatenate([seq, [eos_token_id]])))
                    if len(hyps[b]) > nb:
                        # keep only the best nb
                        hyps[b].remove(min(hyps[b], key=lambda t: t[0]))
                    continue
                if live < nb:
                    beam_idx[b, live] = b * nb + src
                    beam_tok[b, live] = tok
                    new_scores[b, live] = sc
                    live += 1
            if live < nb:          # pathological: pad with beam 0
                beam_idx[b, live:] = b * nb
                new_scores[b, live:] = -1e9
            # is_done (early_stopping=False): once nb hypotheses exist and
            # the best of all 2*nb candidates cannot beat the worst kept
            # one, the pool freezes
            if len(hyps[b]) >= nb:
                best_possible = float(top_s[b][0]) / (
                    (arr_np.shape[1] + 1) ** length_penalty)
                if min(h[0] for h in hyps[b]) >= best_possible:
                    done[b] = True
        if all(done):
            break
        flat_idx = beam_idx.reshape(-1)
        arr_np = np.concatenate([arr_np[flat_idx], beam_tok.reshape(-1, 1)],
                                axis=1)
        beam_scores = torch.from_numpy(new_scores).to(dev)
        if it == max_new - 1:
            # the loop is over: this step's forward (and the reorder that
            # feeds it) would be discarded
            continue
        if supports_cache:
            # the permutation and the new tokens in one copy to the device
            moved = torch.from_numpy(np.concatenate(
                [flat_idx, beam_tok.reshape(-1)])).to(dev)
            past = _reorder_past(past, moved[:B * nb])
            logits, past = model(moved[B * nb:, None], past=past,
                                 use_cache=True)
        else:
            logits = model(torch.from_numpy(arr_np).to(dev))
        steps += 1

    # finalize: the live beams of rows not done join their pools
    bs = beam_scores.cpu().numpy()
    full_len = arr_np.shape[1]
    for b in range(B):
        if done[b]:
            continue
        for j in range(nb):
            hyps[b].append(
                (float(bs[b, j]) / (max(full_len, 1) ** length_penalty),
                 arr_np[b * nb + j]))
    best = [max(h, key=lambda t: t[0]) for h in hyps]
    width = max(len(s) for _, s in best)
    pad = pad_token_id if pad_token_id is not None else (
        eos_token_id if eos_token_id is not None else 0)
    out = np.full((B, width), pad, arr_np.dtype)
    for b, (_, seq) in enumerate(best):
        out[b, :len(seq)] = seq
    _record(loop="beam", steps=steps, host_reads=reads,
            generated=width - s_prompt, scores=[sc for sc, _ in best])
    return torch.from_numpy(out).to(dev)


def decode_loop(model, input_ids, **kwargs):
    """The compiled decode entry: :func:`generate` with the token loop on
    the model's decode step (K6a/K6b/K6c per layer), sampling and EOS on
    the device.  Requests it cannot run (another strategy, no cache) take
    the eager loop, as in the JAX package."""
    return generate(model, input_ids, _megakernel=True, **kwargs)


def generate(model, input_ids, max_new_tokens: int = 20,
             max_length: Optional[int] = None,
             decode_strategy: str = "greedy_search",
             temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None, num_beams: int = 1,
             length_penalty: float = 1.0,
             pad_token_id: Optional[int] = None,
             use_cache: bool = True, use_paged_cache: bool = False,
             _megakernel: Optional[bool] = None, *,
             generator: Optional[torch.Generator] = None, **unused):
    """``input_ids [B, S]`` (a tensor or an array) -> ``[B, S + n]``
    token ids on the model's device, ``n <= max_new_tokens`` (fewer when
    every row has met ``eos_token_id``).  ``decode_strategy``
    ``"greedy_search"`` or ``"sampling"`` (``temperature``, ``top_k``,
    ``top_p``), drawing from ``generator`` (default: the model's own).
    ``num_beams > 1`` runs beam search (``length_penalty``; rows padded
    with ``pad_token_id``, else the eos, else 0) over the dense cache;
    ``use_paged_cache`` runs the eager loop over page pools.
    ``_megakernel`` picks the compiled loop (:func:`decode_loop`), which
    neither of those takes; ``None`` means FLAGS_megakernel_decode's
    default, off.  The reference ignores keywords it does not know
    (``**unused``); here they raise ``NotImplementedError``, so that a
    misspelt option is not silently dropped."""
    if unused:
        raise NotImplementedError(f"generate does not take "
                                  f"{sorted(unused)}")
    dev = model.device
    ids = torch.as_tensor(input_ids, device=dev)
    if ids.dim() != 2:
        raise ValueError(f"input_ids must be [B, S], got {tuple(ids.shape)}")
    s_prompt = ids.shape[1]
    if max_length is not None:
        max_new_tokens = max(int(max_length) - s_prompt, 0)
    # rope / position embeddings have nothing past max_position_embeddings
    max_pos = getattr(getattr(model, "config", None),
                      "max_position_embeddings", None)
    if max_pos is not None:
        room = int(max_pos) - s_prompt
        if room <= 0:
            raise ValueError(f"prompt length {s_prompt} already reaches "
                             f"max_position_embeddings {max_pos}")
        max_new_tokens = min(int(max_new_tokens), room)
    max_new = int(max_new_tokens)
    # cache support is a signature property, as in the JAX package
    params = inspect.signature(model.forward).parameters
    supports_cache = use_cache and "use_cache" in params
    last_only = supports_cache and "last_logits_only" in params
    mk_reason = _megakernel_fallback_reason(
        model, decode_strategy, num_beams, use_paged_cache,
        supports_cache, max_new) if _megakernel else None
    compiled = bool(_megakernel) and mk_reason is None
    gen = generator if generator is not None else model.generator
    args = (model, ids, max_new, decode_strategy, temperature, top_k, top_p,
            eos_token_id)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            if compiled:
                # the whole compiled generation (prefill + token loop) is
                # one span; the decode_compile child and the decode_loop
                # event land inside it, as in the reference
                with tracing.trace_span(
                        "decode_loop",
                        attrs={"model": type(model).__name__,
                               "strategy": decode_strategy}):
                    out = _compiled_decode(*args, last_only, gen)
                    events.emit("decode_loop", model=type(model).__name__,
                                batch=int(ids.shape[0]),
                                prompt_len=int(s_prompt),
                                max_new_tokens=max_new,
                                generated=int(out.shape[1]) - s_prompt,
                                strategy=decode_strategy, compiled=True)
                return out
            if _megakernel:
                events.emit("decode_loop", model=type(model).__name__,
                            batch=int(ids.shape[0]),
                            prompt_len=int(s_prompt),
                            max_new_tokens=max_new,
                            strategy=decode_strategy, compiled=False,
                            fallback=mk_reason)
            if num_beams > 1:
                if decode_strategy not in ("beam_search",) + _GREEDY:
                    raise NotImplementedError(
                        f"num_beams={num_beams} with decode_strategy="
                        f"{decode_strategy!r}: beam-sampling is not "
                        "implemented — temperature/top_k/top_p would be "
                        "silently ignored")
                if use_paged_cache:
                    raise ValueError(
                        "beam search reorders cache rows every step; the "
                        "page pool does not support row permutation — use "
                        "the dense cache (use_paged_cache=False)")
                return _beam_search(model, ids, max_new, num_beams,
                                    length_penalty, eos_token_id,
                                    supports_cache, last_only,
                                    pad_token_id=pad_token_id)
            return _eager_decode(*args, supports_cache, last_only, gen,
                                 use_paged_cache)
    finally:
        if was_training:
            model.train()


def seq2seq_generate(decode_step, start_token_id, batch, max_new_tokens,
                     eos_token_id, pad_token_id, num_beams=1,
                     length_penalty=1.0, forced_eos_token_id=None,
                     max_positions=None, device=None):
    """The encoder-decoder decode: ``decode_step(dec_ids [batch, t]) ->
    logits [batch, t, V]`` closes over the (beam-expanded, if needed)
    encoder memory.  Greedy rows hold at ``pad_token_id`` after eos;
    ``num_beams > 1`` runs the HF-semantics beam search;
    ``forced_eos_token_id`` forces the final slot.  The decoder ids live
    on ``device`` (``None``: the CUDA card, raising without one)."""
    dev = default_device(device)
    if max_positions is not None and \
            1 + int(max_new_tokens) > int(max_positions):
        raise ValueError(
            f"decoder length 1+{max_new_tokens} exceeds "
            f"max_position_embeddings {max_positions}")
    if num_beams > 1:
        start = torch.full((batch, 1), start_token_id, dtype=torch.int64,
                           device=dev)
        return _beam_search(decode_step, start, max_new_tokens,
                            int(num_beams), length_penalty, eos_token_id,
                            supports_cache=False, last_only=False,
                            pad_token_id=pad_token_id,
                            forced_eos_token_id=forced_eos_token_id)
    dec = np.full((batch, 1), start_token_id, np.int64)
    finished = np.zeros((batch,), bool)
    for it in range(int(max_new_tokens)):
        logits = decode_step(torch.from_numpy(dec).to(dev))
        if forced_eos_token_id is not None and \
                it == int(max_new_tokens) - 1:
            nxt = np.full((batch,), forced_eos_token_id, np.int64)
        else:
            nxt = logits[:, -1, :].argmax(-1).cpu().numpy()
        nxt = np.where(finished, pad_token_id, nxt)
        dec = np.concatenate([dec, nxt[:, None].astype(np.int64)], 1)
        if eos_token_id is not None:
            finished |= nxt == eos_token_id
            if finished.all():
                break
    return torch.from_numpy(dec).to(dev)


def _scatter_pages(pages, vals, page_ids, slots):
    """Write one step's new k/v rows into a page pool IN PLACE (JAX
    returns a new array; here ``index_put_`` updates the pool the engine
    keeps).  ``pages [nkv, P, ps, hd]``; ``vals [B, Q, nkv, hd]``;
    ``page_ids/slots [B, Q]``.  Every padding slot targets the engine's
    sink page, so several writes may land on the same sink row: which
    one wins does not matter, because the sink is never read."""
    nkv, hd = vals.shape[2], vals.shape[3]
    flat = vals.reshape(-1, nkv, hd).transpose(0, 1)        # [nkv, BQ, hd]
    pages[:, page_ids.reshape(-1).long(), slots.reshape(-1).long()] = \
        flat.to(pages.dtype)
    return pages


def _last_valid_rows(h, q_lens):
    """Each sequence's LAST valid query row of ``h [B, Q, H]`` (row
    ``q_lens[b] - 1``; padding slots clamp to row 0), so the lm-head
    matmul runs on [B, H] instead of every padded token."""
    b, qw = h.shape[0], h.shape[1]
    idx = (q_lens.long() - 1).clamp(0, qw - 1)
    return h[torch.arange(b, device=h.device), idx]


def build_ragged_decode_step(model):
    """Cache-aware BATCHED decode step over paged KV pools.

    Returns ``(params, step)`` with::

        step(params, tok [B, Q], pos [B, Q], pools, page_ids [B, Q],
             slots [B, Q], kv_lens [B], q_lens [B], tables [B, ppseq])
          -> (last_logits [B, V], pools)

    where ``pools`` is a per-layer sequence of ``(k_pages, v_pages)``
    ``[nkv, P, ps, hd]`` pools shared by every sequence; they are
    updated in place and returned.  Each sequence contributes
    ``q_lens[b]`` new tokens (a prefill chunk or one decode token,
    padded to ``Q``); their k/v land at ``(page_ids, slots)`` BEFORE the
    one-launch ragged paged attention, so the new tokens attend to
    themselves causally.  ``params`` are views of the model's
    parameters in the JAX step's layout.

    The family is read off the layout of the model's
    ``build_decode_step`` params, as in the JAX package: GPT
    (``blocks``) or LLaMA (``layers``)."""
    params, _ = model.build_decode_step()
    if "layers" in params:
        return params, _llama_ragged_step(model.config)
    if "blocks" in params:
        return _gpt_ragged_step(model)
    raise TypeError(
        f"{type(model).__name__}.build_decode_step() params carry "
        "neither a GPT ('blocks') nor a LLaMA ('layers') layout — "
        "build_ragged_decode_step has no adapter for it")


def _gpt_ragged_step(model):
    """GPT's step; its params hold each block's packed ``[H, 3H]``
    q/k/v weight, so one product gives q, k and v."""
    c = model.config
    nh = int(c.num_heads)
    hidden = int(c.hidden_size)
    hd = hidden // nh
    gpt = model.gpt
    params = {
        "wte": gpt.embeddings.word_embeddings.weight,
        "wpe": gpt.embeddings.position_embeddings.weight,
        "blocks": [{
            "ln1_w": blk.ln1.weight, "ln1_b": blk.ln1.bias,
            # packed [H, 3H] / [3H]: contiguous q, k, v thirds
            "wqkv": blk.attn.qkv_proj.weight, "bqkv": blk.attn.qkv_proj.bias,
            "wo": blk.attn.out_proj.weight, "bo": blk.attn.out_proj.bias,
            "ln2_w": blk.ln2.weight, "ln2_b": blk.ln2.bias,
            "w1": blk.mlp.fc1.weight, "b1": blk.mlp.fc1.bias,
            "w2": blk.mlp.fc2.weight, "b2": blk.mlp.fc2.bias,
        } for blk in gpt.layers],
        "lnf_w": gpt.final_ln.weight, "lnf_b": gpt.final_ln.bias,
        "lm_w": model.lm_weight(),
    }

    @torch.no_grad()
    def step(p, tok, pos, pools, page_ids, slots, kv_lens, q_lens, tables):
        b, qw = tok.shape
        x = p["wte"][tok.long()] + p["wpe"][pos.long()]      # [B, Q, H]
        for i, bp in enumerate(p["blocks"]):
            h = _fd.reference_layer_norm(x, bp["ln1_w"], bp["ln1_b"], 1e-5)
            qkv = torch.matmul(h.reshape(b * qw, hidden), bp["wqkv"]) \
                + bp["bqkv"]
            qp, kp, vp = (t.reshape(b, qw, nh, hd)
                          for t in qkv.split(hidden, dim=-1))
            kpg = _scatter_pages(pools[i][0], kp, page_ids, slots)
            vpg = _scatter_pages(pools[i][1], vp, page_ids, slots)
            ctx = ragged_paged_attention(qp.contiguous(), kpg, vpg,
                                         kv_lens, q_lens, tables)
            x = x + (torch.matmul(ctx.reshape(b, qw, hidden), bp["wo"])
                     + bp["bo"])
            x = x + _fd.norm_mlp(
                x.reshape(b * qw, hidden), kind="layer_norm",
                norm_w=bp["ln2_w"], norm_b=bp["ln2_b"],
                w1=bp["w1"], b1=bp["b1"], w2=bp["w2"], b2=bp["b2"],
                eps=1e-5, act="gelu_tanh").reshape(b, qw, hidden)
        h = _fd.reference_layer_norm(x, p["lnf_w"], p["lnf_b"], 1e-5)
        logits = torch.matmul(_last_valid_rows(h, q_lens),
                              p["lm_w"].transpose(0, 1))
        return logits, pools

    return params, step


def _llama_ragged_step(c):
    """LLaMA's step over the params of ``build_decode_step`` (the JAX
    step's LLaMA branch): the embedding times ``embed_scale``, the rope
    rows gathered at ``pos`` (interleaved), RMSNorm with the rsqrt cast
    back first, three q/k/v products with optional biases, GQA through
    the ragged kernel, then RMSNorm + SwiGLU (or ``gelu_tanh``) through
    ``norm_mlp`` (K6c on the card at <= 64 rows), and a tied or untied
    head on each sequence's last valid row."""
    nh, nkv = int(c.num_heads), int(c.num_kv_heads)
    hidden = int(c.hidden_size)
    hd = hidden // nh
    eps, act, scale = float(c.rms_eps), c.hidden_act, float(c.embed_scale)

    @torch.no_grad()
    def step(p, tok, pos, pools, page_ids, slots, kv_lens, q_lens, tables):
        b, qw = tok.shape
        x = p["embed"][tok.long()]
        if scale != 1.0:
            x = x * scale
        cos = p["cos"][pos.long()][:, :, None, :]           # [B, Q, 1, hd]
        sin = p["sin"][pos.long()][:, :, None, :]
        for i, lp in enumerate(p["layers"]):
            h2 = _fd.reference_rms_norm(x, lp["ln1_w"], eps) \
                .reshape(b * qw, hidden)
            qp = torch.matmul(h2, lp["wq"]).reshape(b, qw, nh, hd)
            kp = torch.matmul(h2, lp["wk"]).reshape(b, qw, nkv, hd)
            vp = torch.matmul(h2, lp["wv"]).reshape(b, qw, nkv, hd)
            if lp["bq"] is not None:
                qp = qp + lp["bq"].reshape(nh, hd)
            if lp["bk"] is not None:
                kp = kp + lp["bk"].reshape(nkv, hd)
            if lp["bv"] is not None:
                vp = vp + lp["bv"].reshape(nkv, hd)
            qp = _fd.reference_rope_rows(qp, cos, sin)
            kp = _fd.reference_rope_rows(kp, cos, sin)
            kpg = _scatter_pages(pools[i][0], kp, page_ids, slots)
            vpg = _scatter_pages(pools[i][1], vp, page_ids, slots)
            ctx = ragged_paged_attention(qp.contiguous(), kpg, vpg,
                                         kv_lens, q_lens, tables)
            x = x + torch.matmul(ctx.reshape(b, qw, nh * hd), lp["wo"])
            x = x + _fd.norm_mlp(
                x.reshape(b * qw, hidden), kind="rms_norm",
                norm_w=lp["ln2_w"], w_gate=lp["wg"], w1=lp["wu"],
                w2=lp["wd"], eps=eps, act=act).reshape(b, qw, hidden)
        h = _fd.reference_rms_norm(x, p["norm_w"], eps)
        logits = torch.matmul(_last_valid_rows(h, q_lens),
                              p["lm_w"].transpose(0, 1))
        return logits, pools

    return step


def serving_sample(logits, temps, generator):
    """Next token per lane of a serving step, on the device: argmax
    where ``temperature == 0``, else a categorical draw on ``logits /
    max(t, 1e-6)`` (Gumbel-max: ONE ``torch.rand`` of the logits' shape
    from ``generator`` per call, greedy lanes included, so the stream
    advances alike whatever the lanes' temperatures).  A lane whose
    logits hold a NaN gets -1."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(
        u.clamp_min(torch.finfo(torch.float32).tiny)))
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    sampled = (scaled + gumbel).argmax(dim=-1)
    nxt = torch.where(temps > 0, sampled, greedy)
    nxt = torch.where(torch.isnan(logits).any(dim=-1),
                      torch.full_like(nxt, -1), nxt)
    return nxt.to(torch.int32)


def build_fused_window_step(model, max_window: int):
    """The serving window: up to ``max_window`` ragged decode iterations
    (Q = 1) with one host read at the end — the port of the JAX
    package's ``build_fused_window_step``, whose ``lax.while_loop`` is a
    host loop of the same step here.

    Returns ``(params, window)`` with::

        window(params, tok [B], pools, kv_lens [B], live [B] bool,
               tables [B, ppseq], temps [B], eos_ids [B], budgets [B],
               generator, n_steps, *, rng_states=None)
          -> (packed [B, max_window + 2] int32, pools)

    ``kv_lens`` are the PRE-append lengths; ``tok`` is each live lane's
    pending token; ``n_steps`` (a host int, 1..``max_window``) is the
    number of iterations dispatched.  Each iteration re-derives the
    page-append cursors on the device (``append_positions``), runs the
    ragged step at Q = 1 and samples with :func:`serving_sample`, one
    draw from ``generator`` per iteration.  EOS, budget and
    ``finished`` stay on the device and nothing is read back inside the
    loop, so the loop cannot stop on the first finish as the JAX loop
    does: once any lane has finished, ``~any(finished)`` is folded into
    ``live`` and every remaining iteration runs at ``q_lens = 0``,
    writing only the sink page and changing no token, length, buffer
    column or count.  Tokens, pools at every live position and the
    iteration count then equal the JAX window's.  A lane sampling the
    NaN sentinel (-1) finishes there.

    ``packed`` is the one host read: columns ``[:max_window]`` hold the
    per-lane tokens (column ``j`` = iteration ``j``; only the first
    ``steps`` are live), column ``[max_window]`` the finished mask and
    column ``[max_window + 1]`` the iterations that ran (``steps``),
    broadcast to every lane.  ``rng_states``, a list, receives
    ``generator.get_state()`` before the first draw and after each
    (host state, no device read): restoring ``rng_states[steps]`` after
    the read leaves the generator where ``steps`` single steps would."""
    params, step = build_ragged_decode_step(model)
    max_window = int(max_window)

    @torch.no_grad()
    def window(p, tok, pools, kv_lens, live, tables, temps, eos_ids,
               budgets, generator, n_steps, *, rng_states=None):
        n = int(n_steps)
        if not 1 <= n <= max_window:
            raise ValueError(f"n_steps={n} is outside 1..{max_window}")
        b = tok.shape[0]
        dev = tok.device
        page_size, sink = pools[0][0].shape[2], pools[0][0].shape[1] - 1
        tok = tok.to(torch.int32)
        kv = kv_lens.to(torch.int32)
        live = live.to(torch.bool)
        temps = temps.float()
        eos_ids = eos_ids.to(torch.int32)
        budgets = budgets.to(torch.int32)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        ngen = torch.zeros(b, dtype=torch.int32, device=dev)
        ran = torch.zeros((), dtype=torch.int32, device=dev)
        buf = torch.zeros(b, max_window, dtype=torch.int32, device=dev)
        if rng_states is not None:
            rng_states.append(generator.get_state())
        zero = torch.zeros_like(tok)
        for i in range(n):
            go = ~finished.any()      # False from the first finish on
            act = live & go
            q_lens = act.to(torch.int32)
            page_ids, slots = append_positions(kv, tables, act, page_size,
                                               sink)
            kv_next = kv + q_lens
            logits, pools = step(p, tok[:, None], kv[:, None], pools,
                                 page_ids[:, None], slots[:, None],
                                 kv_next, q_lens, tables)
            nxt = serving_sample(logits, temps, generator)
            if rng_states is not None:
                rng_states.append(generator.get_state())
            # as the JAX loop: every lane's draw lands in the buffer
            # (dead lanes' too) and live lanes feed theirs back
            buf[:, i] = torch.where(go, nxt, buf[:, i])
            ngen += q_lens
            finished |= act & ((nxt == eos_ids) | (ngen >= budgets)
                               | (nxt < 0))
            tok = torch.where(go, torch.where(live, nxt, zero), tok)
            kv = kv_next
            ran += go.to(torch.int32)
        packed = torch.cat([buf, finished.to(torch.int32)[:, None],
                            ran.expand(b)[:, None]], dim=1)
        return packed, pools

    return params, window
