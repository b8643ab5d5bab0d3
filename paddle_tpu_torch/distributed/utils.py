"""``paddle.distributed.utils`` MoE token-dispatch helpers; counterpart
of ``paddle_tpu/distributed/utils.py`` (ref:
``python/paddle/distributed/utils/moe_utils.py`` ``global_scatter`` /
``global_gather`` and the ``expert_count`` op behind them).

The JAX package keeps them exact at a world of one, where every expert
is local and the dispatch is the identity.  With one process per card
they are the ragged all-to-all its docstring names: ``local_count[j *
n_expert + e]`` rows go to expert ``e`` of rank ``j`` (``x`` holds them
rank-major, then expert), ``global_count[j * n_expert + e]`` rows come
from rank ``j`` for this rank's expert ``e``, and :func:`global_scatter`
returns them expert-major, then by source rank, as the reference's op
does; :func:`global_gather` is its inverse (and its gradient).  The
split sizes are read on the host.  ``MoELayer`` does not use them: its
capacity-based dispatch keeps the JAX package's semantics
(``incubate.distributed.models.moe``).
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["global_scatter", "global_gather", "expert_count"]


def expert_count(gate_idx, n_expert: int) -> torch.Tensor:
    """ref: the ``expert_count`` op — tokens per expert, int64
    ``[n_expert]``."""
    idx = torch.as_tensor(gate_idx).reshape(-1).to(torch.int64)
    return torch.bincount(idx, minlength=int(n_expert))


def _counts(c) -> List[int]:
    return [int(v) for v in torch.as_tensor(c).reshape(-1).tolist()]


def _group(group):
    """The group of the exchange, or None for a world of one."""
    from .env import is_initialized
    from .communication.group import _resolve_group
    if group is None and not is_initialized():
        return None
    g = _resolve_group(group)
    return g if g.nranks > 1 else None


def _check(counts: List[int], x: torch.Tensor, name: str):
    if sum(counts) != int(x.shape[0]):
        raise ValueError(f"{name} sums to {sum(counts)} but x has "
                         f"{int(x.shape[0])} rows")


def _sizes(local: List[int], glob: List[int], n: int):
    """Per rank: the rows sent (local) and received (global), and the
    per (rank, expert) counts as an ``[n, n_expert]`` table each."""
    if len(local) != len(glob) or len(local) % n:
        raise ValueError(f"local_count ({len(local)}) and global_count "
                         f"({len(glob)}) must both hold world size ({n}) "
                         "x n_expert entries")
    e = len(local) // n
    lt = [local[j * e:(j + 1) * e] for j in range(n)]
    gt = [glob[j * e:(j + 1) * e] for j in range(n)]
    return [sum(r) for r in lt], [sum(r) for r in gt], lt, gt, e


def _reorder(x: torch.Tensor, table: List[List[int]], to_expert: bool):
    """Rows grouped ``[rank][expert]`` reordered ``[expert][rank]``
    (``to_expert``) or back."""
    n, e = len(table), len(table[0]) if table else 0
    offs, pieces = {}, []
    start = 0
    order = [(j, i) for j in range(n) for i in range(e)] if to_expert \
        else [(j, i) for i in range(e) for j in range(n)]
    for j, i in order:
        offs[(j, i)] = start
        start += table[j][i]
    want = [(j, i) for i in range(e) for j in range(n)] if to_expert \
        else [(j, i) for j in range(n) for i in range(e)]
    for j, i in want:
        c = table[j][i]
        if c:
            pieces.append(x[offs[(j, i)]:offs[(j, i)] + c])
    if not pieces:
        return x[:0]
    return torch.cat(pieces, dim=0)


def _exchange(x, send: List[int], recv: List[int], g):
    from .communication.collective_ops import alltoall_single
    return alltoall_single(x.contiguous(), in_split_sizes=send,
                           out_split_sizes=recv, group=g)


def _scatter(x, local, glob, g):
    send, recv, _, gt, _ = _sizes(local, glob, g.nranks)
    out = _exchange(x, send, recv, g)          # [source rank][expert]
    return _reorder(out, gt, to_expert=True)


def _gather(x, local, glob, g):
    send, recv, _, gt, _ = _sizes(local, glob, g.nranks)
    x = _reorder(x, gt, to_expert=False)       # back to [rank][expert]
    return _exchange(x, recv, send, g)


class _GlobalScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, local, glob, g):
        ctx.counts = (local, glob, g)
        return _scatter(x, local, glob, g)

    @staticmethod
    def backward(ctx, gy):
        local, glob, g = ctx.counts
        return _gather(gy, local, glob, g), None, None, None


class _GlobalGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, local, glob, g):
        ctx.counts = (local, glob, g)
        return _gather(x, local, glob, g)

    @staticmethod
    def backward(ctx, gy):
        local, glob, g = ctx.counts
        return _scatter(gy, local, glob, g), None, None, None


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream: bool = True) -> torch.Tensor:
    """ref: ``moe_utils.global_scatter`` — send expert-grouped rows to the
    ranks owning each expert (module docstring).  ``use_calc_stream`` is
    accepted; the exchange runs on the current stream."""
    local, glob = _counts(local_count), _counts(global_count)
    _check(local, x, "local_count")
    g = _group(group)
    if g is None:
        return x
    return _GlobalScatter.apply(x, local, glob, g)


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream: bool = True) -> torch.Tensor:
    """ref: ``moe_utils.global_gather`` — the inverse of
    :func:`global_scatter`."""
    local, glob = _counts(local_count), _counts(global_count)
    _check(glob, x, "global_count")
    g = _group(group)
    if g is None:
        return x
    return _GlobalGather.apply(x, local, glob, g)
