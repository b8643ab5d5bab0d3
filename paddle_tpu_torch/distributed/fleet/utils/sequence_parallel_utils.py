"""Megatron sequence parallelism; counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py`` (ref:
``fleet/utils/sequence_parallel_utils.py``).

Between transformer blocks the activations ``[B, S, H]`` are split along
the sequence (axis 1, ``_SEQ_AXIS``) over the mp group.  Before the
column-parallel products (qkv, fc1) an all-gather restores the full
sequence; after the row-parallel ones (out_proj, fc2) a reduce-scatter
sums the partial products and splits the sequence again.  In the JAX
package these are sharding-spec transitions that the partitioner
lowers; here each is an autograd function on the mp group whose backward
is the transposed collective (``ScatterOp``: split / all-gather,
``GatherOp`` and ``AllGatherOp``: all-gather / split and reduce-scatter,
``ReduceScatterOp``: reduce-scatter / all-gather).

**Gradients of replicated parameters.**  A LayerNorm or RMSNorm weight
(and a row-parallel bias) applied to a rank's sequence chunk gets the
gradient of that chunk only.  The JAX package's partitioner sums them
(its ``register_sequence_parallel_allreduce_hooks`` is a no-op); here
:func:`register_sequence_parallel_allreduce_hooks` sums every parameter
marked by :func:`mark_as_sequence_parallel_parameter` over the mp group
as its gradient is accumulated.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from ...communication.collective_ops import _collective_entry
from ..meta_parallel.parallel_layers.mp_layers import (ColumnParallelLinear,
                                                       RowParallelLinear)
from ..meta_parallel.parallel_layers.mp_ops import (_Concat, _gather,
                                                    _live, _ReduceScatter,
                                                    _Split, mp_group)

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "scatter", "all_gather", "reduce_scatter",
           "mark_as_sequence_parallel_parameter",
           "is_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]

_SEQ_AXIS = 1  # [B, S, H]


class _AllGatherRS(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward (the input of a
    column-parallel product under sequence parallelism)."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.axis, ctx.group), None, None


class ScatterOp:
    """Forward: this rank's chunk of the sequence; backward: all-gather."""

    @staticmethod
    def apply(x, axis: int = _SEQ_AXIS, group=None):
        group = mp_group(group)
        return _Split.apply(x, axis, group) if _live(group) else x


class GatherOp:
    """Forward: all-gather the sequence; backward: this rank's chunk."""

    @staticmethod
    def apply(x, axis: int = _SEQ_AXIS, group=None):
        group = mp_group(group)
        return _Concat.apply(x, axis, group) if _live(group) else x


class AllGatherOp:
    """Forward: all-gather the sequence; backward: reduce-scatter."""

    @staticmethod
    def apply(x, axis: int = _SEQ_AXIS, group=None):
        group = mp_group(group)
        return _AllGatherRS.apply(x, axis, group) if _live(group) else x


class ReduceScatterOp:
    """Forward: reduce-scatter the sequence; backward: all-gather."""

    @staticmethod
    def apply(x, axis: int = _SEQ_AXIS, group=None):
        group = mp_group(group)
        return _ReduceScatter.apply(x, axis, group) if _live(group) else x


scatter = ScatterOp.apply
all_gather = AllGatherOp.apply
reduce_scatter = ReduceScatterOp.apply


def mark_as_sequence_parallel_parameter(parameter) -> None:
    """Mark a replicated parameter applied to sequence chunks: its
    gradient is summed over the mp group by the hooks below."""
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter) -> bool:
    return bool(getattr(parameter, "sequence_parallel", False))


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps: int = 1,
        fuse_sequence_parallel_allreduce: bool = False):
    """On each sequence-parallel parameter of ``model``, a hook that sums
    its gradient over the mp group once every ``accumulation_steps``
    accumulations (the accumulated gradient, at the last micro-step).
    Registering twice changes nothing.  ``fuse_sequence_parallel_
    allreduce`` (one coalesced reduction) raises
    ``NotImplementedError``."""
    if fuse_sequence_parallel_allreduce:
        raise NotImplementedError("fuse_sequence_parallel_allreduce waits "
                                  "for a later slice")
    if accumulation_steps < 1:
        raise ValueError("accumulation_steps must be >= 1")
    group = mp_group(None)
    if not _live(group):
        return None
    for p in model.parameters():
        if not is_sequence_parallel_parameter(p) or \
                getattr(p, "_sp_hooked", False):
            continue
        p._sp_hooked = True
        p._sp_count = 0

        def hook(param, k=accumulation_steps, g=group):
            param._sp_count += 1
            if param._sp_count % k:
                return
            _collective_entry("all_reduce", g, tensor=param.grad)
            tdist.all_reduce(param.grad, group=g.process_group)
        p.register_post_accumulate_grad_hook(hook)
    return None


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """ref: ``ColumnSequenceParallelLinear``: all-gather the sequence
    (backward: reduce-scatter, summed in fp32 as ``mp_layers`` says),
    then the column-parallel product; the
    output stays split (``gather_output=True`` raises
    ``NotImplementedError``, as the reference asserts)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, generator=None, device=None):
        if gather_output:
            raise NotImplementedError("ColumnSequenceParallelLinear with "
                                      "gather_output")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         False, fuse_matmul_bias, mp_group, name,
                         generator=generator, device=device)

    _sp_input = True


class RowSequenceParallelLinear(RowParallelLinear):
    """ref: ``RowSequenceParallelLinear``: the row-parallel product, then
    a reduce-scatter of the sequence, then the bias (marked sequence
    parallel).  ``input_is_parallel=False`` raises
    ``NotImplementedError``, as the reference asserts."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 generator=None, device=None):
        if not input_is_parallel:
            raise NotImplementedError("RowSequenceParallelLinear with "
                                      "input_is_parallel=False")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         True, fuse_matmul_bias, mp_group, name,
                         generator=generator, device=device)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    _sp_output = True
