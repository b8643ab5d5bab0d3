"""Manual gradient sync and parameter broadcasts; counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``.

In the JAX package these are deliberate no-ops: its gradients are global
arrays that the jitted step already reduced.  With one process per card
they communicate, so they compute what the JAX step computes: the
gradients' average over the data-parallel group, and one rank's
parameters on every rank.  Tensors are coalesced per dtype into one flat
buffer per call.

Under an expert degree (ep) the data-parallel group leaves the ep axis
out, so dense and expert gradients are averaged over dp only, and the
dp broadcast sends within it: the ranks of an ep group hold their own
experts, and their dense gradients are equal already (the MoE layer's
collectives sum every partial over ep inside the backward).

Under sep (Ulysses) or cp (ring attention) each rank of that group sees
its own tokens of the same rows with replicated parameters, so
:func:`fused_allreduce_gradients` sums the gradients over it as well
(averaging over dp only), bf16 ones in fp32; over dp alone gradients are
summed in their own dtype.  A pipeline stage's gradients
(:func:`pipeline_allreduce_gradients`) are averaged over dp and, for a
weight several stages share, summed over those stages.  The
model-parallel broadcast sends what the
group's first rank holds of the parameters replicated across the group:
a tensor-parallel shard (``split_axis``) differs by rank and is left
alone.  A sep or cp group's ranks share their mp coordinate, so they
hold the same shards and everything is sent.
"""
from __future__ import annotations

from typing import Iterable, List

import torch

from ...communication.collective_ops import all_reduce, broadcast
from ...communication.group import ReduceOp, _resolve_group

__all__ = ["fused_allreduce_gradients", "fused_allreduce_gradients_with_group",
           "broadcast_dp_parameters", "broadcast_sharding_parameters",
           "broadcast_mp_parameters", "broadcast_sep_parameters",
           "broadcast_cp_parameters", "pipeline_allreduce_gradients",
           "sharding_reduce_gradients"]


def _by_dtype(tensors: Iterable[torch.Tensor]):
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


# the largest flat copy a call makes (a tensor above it gets its own)
_FLAT_BYTES = 256 << 20


def _chunks(ts: List[torch.Tensor]):
    chunk, size = [], 0
    for t in ts:
        nbytes = t.numel() * t.element_size()
        if chunk and size + nbytes > _FLAT_BYTES:
            yield chunk
            chunk, size = [], 0
        chunk.append(t)
        size += nbytes
    if chunk:
        yield chunk


@torch.no_grad()
def _coalesced(tensors: List[torch.Tensor], fn) -> None:
    """``fn`` on flat copies of each dtype's tensors (up to
    ``_FLAT_BYTES`` each), copied back."""
    for group in _by_dtype(tensors):
        for ts in _chunks(group):
            flat = torch.cat([t.reshape(-1) for t in ts])
            fn(flat)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def _allreduce_gradients(parameter_list, group, scale=None,
                         fp32: bool = False) -> None:
    g = _resolve_group(group)
    grads = [p.grad for p in parameter_list if p.grad is not None]

    def reduce(flat):
        buf = flat.float() if fp32 and flat.dtype in (
            torch.bfloat16, torch.float16) else flat
        if scale is None:
            all_reduce(buf, op=ReduceOp.AVG, group=g)
        else:
            buf.mul_(scale)
            all_reduce(buf, op=ReduceOp.SUM, group=g)
        if buf is not flat:
            flat.copy_(buf)
    _coalesced(grads, reduce)


def fused_allreduce_gradients_with_group(parameter_list, group, scale=None):
    """Each gradient summed over ``group`` in its own dtype and
    multiplied by ``scale`` (default: averaged)."""
    _allreduce_gradients(parameter_list, group, scale)


def _sequence_allreduce_gradients(parameter_list, group, scale=None):
    """:func:`fused_allreduce_gradients_with_group` over a group that
    holds sep or cp ranks, bf16 / fp16 gradients summed in fp32 and
    rounded once: each rank's gradient is its own tokens' share of one
    sum, which a ring of bf16 hops would round at every hop."""
    _allreduce_gradients(parameter_list, group, scale, fp32=True)


def fused_allreduce_gradients(parameter_list, hcg=None):
    """The gradients averaged over the data-parallel group (every rank
    when ``hcg`` is None) — the manual sync after ``no_sync`` — and
    summed over the sep and cp groups (module docstring)."""
    if hcg is None:
        fused_allreduce_gradients_with_group(parameter_list, None)
        return
    seq = hcg.get_sep_parallel_world_size() * \
        hcg.get_context_parallel_world_size()
    if seq == 1:
        fused_allreduce_gradients_with_group(
            parameter_list, hcg.get_data_parallel_group())
        return
    group = hcg.mesh.group(("dp", "sep", "cp"), name="dp_sep_cp")
    _sequence_allreduce_gradients(
        parameter_list, group, scale=1.0 / hcg.get_data_parallel_world_size())


def pipeline_allreduce_gradients(parameter_list, hcg) -> None:
    """A pipeline stage's gradient sync before its optimizer step: each
    shared weight (``pp_shared_group``: a tied layer held by several
    stages) summed over its stages, then every gradient averaged over the
    data-parallel group, each in its own dtype (once a step: after the
    last micro-batch's backward)."""
    params = [p for p in parameter_list if p.grad is not None]
    for p in params:
        g = getattr(p, "pp_shared_group", None)
        if g is not None:
            all_reduce(p.grad, group=g)
    if hcg is not None and hcg.get_data_parallel_world_size() > 1:
        fused_allreduce_gradients_with_group(params,
                                             hcg.get_data_parallel_group())


def sharding_reduce_gradients(parameter_list, hcg=None):
    """The gradients averaged over the sharding group."""
    group = hcg.get_sharding_parallel_group() if hcg is not None else None
    fused_allreduce_gradients_with_group(parameter_list, group)


def _broadcast_model(model, group, replicated_only: bool = False) -> None:
    g = _resolve_group(group)
    if g.nranks == 1:
        return
    from ..meta_parallel.parallel_layers.mp_layers import is_split
    tensors = [p.data for p in model.parameters()
               if not (replicated_only and is_split(p))]
    tensors += list(model.buffers())
    _coalesced(tensors, lambda flat: broadcast(flat, src=g.ranks[0],
                                               group=g))


def broadcast_dp_parameters(model, hcg=None):
    """The data-parallel group's first rank's parameters and buffers on
    every rank of the group."""
    _broadcast_model(model, hcg.get_data_parallel_group()
                     if hcg is not None else None)


def broadcast_sharding_parameters(model, hcg=None):
    _broadcast_model(model, hcg.get_sharding_parallel_group()
                     if hcg is not None else None)


def broadcast_mp_parameters(model, hcg=None):
    """The mp group's first rank's replicated parameters and buffers on
    every rank of the group (its shards stay)."""
    _broadcast_model(model, hcg.get_model_parallel_group()
                     if hcg is not None else None, replicated_only=True)


def broadcast_sep_parameters(model, hcg=None):
    """The sep group's first rank's parameters and buffers on every rank
    of the group."""
    _broadcast_model(model, hcg.get_sep_parallel_group()
                     if hcg is not None else None)


def broadcast_cp_parameters(model, hcg=None):
    """The cp group's first rank's parameters and buffers on every rank
    of the group."""
    _broadcast_model(model, hcg.get_context_parallel_group()
                     if hcg is not None else None)
