"""Manual gradient sync and parameter broadcasts; counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``.

In the JAX package these are deliberate no-ops: its gradients are global
arrays that the jitted step already reduced.  With one process per card
they communicate, so they compute what the JAX step computes: the
gradients' average over the data-parallel group, and one rank's
parameters on every rank.  Tensors are coalesced per dtype into one flat
buffer per call.  The model-parallel and sequence-parallel broadcasts
wait for slice (c) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Iterable, List

import torch

from ...communication.collective_ops import all_reduce, broadcast
from ...communication.group import ReduceOp, _resolve_group

__all__ = ["fused_allreduce_gradients", "fused_allreduce_gradients_with_group",
           "broadcast_dp_parameters", "broadcast_sharding_parameters",
           "broadcast_mp_parameters", "broadcast_sep_parameters",
           "sharding_reduce_gradients"]


def _by_dtype(tensors: Iterable[torch.Tensor]):
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


@torch.no_grad()
def _coalesced(tensors: List[torch.Tensor], fn) -> None:
    """``fn`` on one flat copy of each dtype's tensors, copied back."""
    for ts in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def fused_allreduce_gradients_with_group(parameter_list, group, scale=None):
    """Each gradient summed over ``group`` and multiplied by ``scale``
    (default: averaged)."""
    g = _resolve_group(group)
    grads = [p.grad for p in parameter_list if p.grad is not None]

    def reduce(flat):
        if scale is None:
            all_reduce(flat, op=ReduceOp.AVG, group=g)
        else:
            flat.mul_(scale)
            all_reduce(flat, op=ReduceOp.SUM, group=g)
    _coalesced(grads, reduce)


def fused_allreduce_gradients(parameter_list, hcg=None):
    """The gradients averaged over the data-parallel group (every rank
    when ``hcg`` is None) — the manual sync after ``no_sync``."""
    group = hcg.get_data_parallel_group() if hcg is not None else None
    fused_allreduce_gradients_with_group(parameter_list, group)


def sharding_reduce_gradients(parameter_list, hcg=None):
    """The gradients averaged over the sharding group."""
    group = hcg.get_sharding_parallel_group() if hcg is not None else None
    fused_allreduce_gradients_with_group(parameter_list, group)


def _broadcast_model(model, group) -> None:
    g = _resolve_group(group)
    tensors = [p.data for p in model.parameters()] + list(model.buffers())
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
    raise NotImplementedError("model parallel waits for the distributed "
                              "slice (c)")


def broadcast_sep_parameters(model, hcg=None):
    raise NotImplementedError("sequence parallel waits for the "
                              "distributed slice (c)")
