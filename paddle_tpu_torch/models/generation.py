"""The ragged batched decode step of the continuous-batching serving
engine; counterpart of ``build_ragged_decode_step`` in
``paddle_tpu/models/generation.py`` (GPT layout; LLaMA waits for a later
slice)."""
from __future__ import annotations

import torch

from ..ops import fused_decode as _fd
from ..ops.ragged_paged_attention import ragged_paged_attention

__all__ = ["build_ragged_decode_step"]


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
    parameters in the JAX step's layout."""
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
