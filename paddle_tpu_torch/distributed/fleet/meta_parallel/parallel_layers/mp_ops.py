"""The model-parallel collectives as autograd functions; counterpart of
the sharding transitions ``paddle_tpu``'s mp layers leave to GSPMD (ref:
``fleet/layers/mpu/mp_ops.py`` ``_c_identity``, ``_mp_allreduce``,
``_c_split``, ``_c_concat``).

The JAX package's parameters are global arrays and the partitioner
inserts these collectives where a sharding changes.  Here each rank
holds its shard, so every transition is an explicit collective on the mp
group (``torch.distributed``: NCCL on the card, gloo on the CPU), and
its backward is the transposed collective:

=================  ==================  ===================
op                 forward             backward
=================  ==================  ===================
``_c_identity``    identity            all-reduce (sum)
``_mp_allreduce``  all-reduce (sum)    identity
``_c_split``       keep this rank's    all-gather
                   chunk of ``axis``
``_c_concat``      all-gather along    keep this rank's
                   ``axis``            chunk
``_reduce_scatter``  reduce-scatter    all-gather
                   along ``axis``
=================  ==================  ===================

On a group of one rank every op returns its input.  ``group`` defaults
to the fleet topology's mp group.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from ....communication.collective_ops import _collective_entry
from ....parallel import all_gather_single, reduce_scatter_single

__all__ = ["_c_identity", "_mp_allreduce", "_c_split", "_c_concat",
           "_reduce_scatter", "mp_group"]


def mp_group(group=None):
    """``group``, or the fleet topology's mp group (None without one)."""
    if group is not None:
        return group
    from ...base.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _live(group) -> bool:
    return group is not None and group.nranks > 1


def _all_reduce(x, group):
    _collective_entry("all_reduce", group, tensor=x)
    out = x.contiguous().clone()
    tdist.all_reduce(out, group=group.process_group)
    return out


def _gather(x, axis, group):
    """Every rank's ``x`` concatenated along ``axis`` in rank order."""
    _collective_entry("all_gather", group, tensor=x)
    n = group.nranks
    x = x.contiguous()
    flat = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    all_gather_single(flat, x, group=group.process_group)
    if axis % x.dim() == 0:
        return flat
    return torch.cat(flat.view((n,) + tuple(x.shape)).unbind(0), dim=axis)


def _split(x, axis, group):
    """This rank's contiguous chunk of ``axis``."""
    n = group.nranks
    if x.shape[axis] % n:
        raise ValueError(f"dimension {axis} ({x.shape[axis]}) does not "
                         f"split over {n} ranks")
    return x.chunk(n, dim=axis)[group.rank].contiguous()


def _scatter_sum(x, axis, group):
    """The sum over ranks of ``x``, this rank's chunk of ``axis``."""
    _collective_entry("reduce_scatter", group, tensor=x)
    n = group.nranks
    if x.shape[axis] % n:
        raise ValueError(f"dimension {axis} ({x.shape[axis]}) does not "
                         f"split over {n} ranks")
    src = torch.cat(x.chunk(n, dim=axis), dim=0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    reduce_scatter_single(out, src, group=group.process_group)
    return out


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _split(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.group), None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.axis, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _scatter_sum(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.group), None, None


def _c_identity(x, group=None):
    """Identity forward, sum over the group backward: the input of a
    column-parallel product, whose ranks each contribute part of its
    gradient."""
    group = mp_group(group)
    return _Identity.apply(x, group) if _live(group) else x


def _mp_allreduce(x, group=None):
    """Sum over the group forward, identity backward: the output of a
    row-parallel product or a vocab-parallel lookup."""
    group = mp_group(group)
    return _AllReduce.apply(x, group) if _live(group) else x


def _c_split(x, group=None, axis: int = -1):
    """This rank's chunk of ``axis`` forward, all-gather backward."""
    group = mp_group(group)
    return _Split.apply(x, axis, group) if _live(group) else x


def _c_concat(x, group=None, axis: int = -1):
    """All-gather along ``axis`` forward, this rank's chunk backward."""
    group = mp_group(group)
    return _Concat.apply(x, axis, group) if _live(group) else x


def _reduce_scatter(x, group=None, axis: int = 1):
    """Sum over the group, this rank's chunk of ``axis``, forward;
    all-gather backward."""
    group = mp_group(group)
    return _ReduceScatter.apply(x, axis, group) if _live(group) else x
