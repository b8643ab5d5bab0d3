"""DeepSpeed-Ulysses sequence parallelism (sep); counterpart of
``paddle_tpu/ops/ulysses.py``.

Each rank of the sep group holds its sequence chunk ``[B, S/n, H, D]``.
An all-to-all (``alltoall_single``) trades the split sequence for split
heads (``[B, S, H/n, D]``), one flash call (K1) attends the whole
sequence on the rank's heads, and the inverse all-to-all splits the
sequence again.  Each all-to-all is an autograd function whose backward
is the other.  On CPU tensors the flash call takes its plain version.
"""
from __future__ import annotations

import torch

from .flash_attention import DEFAULT_BLOCK_Q, flash_attention_bhsd

__all__ = ["ulysses_attention"]


def _alltoall(x, group):
    """``x [n, ...]``: block ``j`` to rank ``j``; returns block ``j`` from
    rank ``j``."""
    from ..distributed.communication.collective_ops import alltoall_single
    return alltoall_single(x.contiguous(), group=group)


def _s2h(x, group):
    b, s, h, d = x.shape
    n = group.nranks
    x = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    y = _alltoall(x, group)                       # [n(seq), b, s, h/n, d]
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _h2s(x, group):
    b, s, h, d = x.shape
    n = group.nranks
    x = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4)
    y = _alltoall(x, group)                       # [n(heads), b, s/n, h, d]
    return y.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _s2h(x, group)

    @staticmethod
    def backward(ctx, g):
        return _h2s(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _h2s(x, group)

    @staticmethod
    def backward(ctx, g):
        return _s2h(g, ctx.group), None


def _seq_to_heads(x, group):
    """``[B, S/n, H, D]`` -> ``[B, S, H/n, D]`` via all-to-all."""
    return _SeqToHeads.apply(x, group)


def _heads_to_seq(x, group):
    """``[B, S, H/n, D]`` -> ``[B, S/n, H, D]``."""
    return _HeadsToSeq.apply(x, group)


def ulysses_attention(q, k, v, axis_name, scale: float, causal: bool = True,
                      interpret: bool = False):
    """Per-rank q / k / v ``[B, S_local, H, D]`` (the sequence split over
    ``axis_name``: a ``Group``, or ``"sep"`` / ``"cp"`` of the fleet
    topology); heads divisible by the group size.  ``interpret`` changes
    nothing."""
    from .ring_attention import _ring_group
    group = _ring_group(axis_name)
    n = group.nranks
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the sep "
            f"degree ({n})")
    s_global = q.shape[1] * n
    bq = min(DEFAULT_BLOCK_Q, s_global)
    if s_global % bq:
        raise ValueError(
            f"ulysses needs the global sequence ({s_global}) aligned to "
            f"the flash block size ({DEFAULT_BLOCK_Q})")
    qg, kg, vg = (_seq_to_heads(t, group) for t in (q, k, v))
    b, s, h, d = qg.shape
    qt, kt, vt = (t.transpose(1, 2).reshape(b * h, s, d)
                  for t in (qg, kg, vg))
    out = flash_attention_bhsd(qt, kt, vt, scale, causal)
    out = out.reshape(b, h, s, d).transpose(1, 2)
    return _heads_to_seq(out, group)
