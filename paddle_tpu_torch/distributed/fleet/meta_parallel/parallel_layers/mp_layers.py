"""Tensor-parallel layers; counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/mp_layers.py``
(ref: ``mp_layers.py`` ``VocabParallelEmbedding``,
``ColumnParallelLinear``, ``RowParallelLinear``,
``ParallelCrossEntropy``).

The JAX package's weights are global arrays with a sharding spec on the
``mp`` axis.  Here each rank of the mp group holds its shard, and the
transitions are the explicit collectives of ``mp_ops`` (Megatron):

* ``ColumnParallelLinear``: ``Y = X [W_1 | ... | W_n]``, the weight
  ``[in, out]`` split by columns; the input passes ``_c_identity`` (or,
  under sequence parallelism, an all-gather of the sequence); the
  output stays split unless ``gather_output``;
* ``RowParallelLinear``: the weight split by rows; the input is split
  (``_c_split``) unless ``input_is_parallel``; the partial products are
  summed (all-reduce, or a reduce-scatter of the sequence), then the
  replicated bias is added;
* ``VocabParallelEmbedding``: the table split by rows (vocabulary); a
  masked local lookup, then the sum over ranks;
* ``ParallelCrossEntropy``: softmax cross entropy over vocab-split
  logits in two passes (the max, then the sum of exponentials, each
  reduced over the group; the target logit from the rank that owns it),
  its backward ``softmax - one_hot`` on each rank's own columns.  At one
  rank it is ``cross_entropy(..., _vocab_sharded=True)``, which stays
  off the softmax-CE kernel K8, as in the JAX package.

**Sums in fp32.**  A rank's partial product (a row-parallel output, a
column-parallel input gradient) is made by cuBLAS in fp32
(``torch.mm(..., out_dtype=torch.float32)`` for bf16 inputs) and summed
over the group in fp32 before the one rounding to the activations'
dtype, as the one-rank product accumulates in fp32 and rounds once.  In
bf16 a rank's rounded partials and a ring's rounded hops nearly double
the gradients' rounding noise against the one-rank model (``PERF.md``,
phase 19).  The summing collectives then move fp32: twice the bytes.
:func:`column_linear` runs the column products of one input (GPT's
packed qkv, LLaMA's q / k / v or gate / up, the vocab-split head) in one
autograd function, so their input gradients are summed in fp32 before
the collective.

Weights are born sharded: a layer draws its whole tensor from
``weight_attr``'s initializer (``generator``, ``device``) and keeps its
shard, so a model built at mp ``n`` draws what the one-rank model draws,
in the same order.  A split parameter carries ``split_axis`` and
``split_groups`` (:func:`is_split`; torch tensors have an
``is_distributed`` method of their own): the axis is cut into
``split_groups`` contiguous groups (3 for GPT's packed ``[q | k | v]``),
each split evenly over the ranks (:func:`shard_of`; :func:`merge_shards`
inverts it, :func:`gather_parameter` gathers a full tensor).  At one rank
every layer computes what the plain layer computes, op for op.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as tdist
from torch import nn

from ..... import amp
from ....communication.collective_ops import _collective_entry
from .....nn import functional as F
from .....nn.initializer import Constant, XavierNormal
from .mp_ops import (_all_reduce, _c_concat, _c_split, _gather,
                     _mp_allreduce, _scatter_sum, mp_group)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "shard_of",
           "merge_shards", "gather_parameter", "is_split", "column_linear"]


def _coords(group):
    group = mp_group(group)
    n = group.nranks if group is not None else 1
    return group, n, (group.rank if n > 1 else 0)


def is_split(param) -> bool:
    """Whether ``param`` is split over the mp group (at one rank: would
    be)."""
    return getattr(param, "split_axis", None) is not None


def shard_of(full: torch.Tensor, axis: int, groups: int, rank: int,
             degree: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``full``: ``axis`` cut into ``groups``
    contiguous groups, each split into ``degree`` pieces; the rank's piece
    of every group, concatenated."""
    if degree == 1:
        return full
    parts = full.chunk(groups, dim=axis)
    return torch.cat([p.chunk(degree, dim=axis)[rank] for p in parts],
                     dim=axis)


def merge_shards(shards: List[torch.Tensor], axis: int,
                 groups: int) -> torch.Tensor:
    """The full tensor from every rank's shard (the inverse of
    :func:`shard_of`)."""
    if len(shards) == 1:
        return shards[0]
    pieces = [s.chunk(groups, dim=axis) for s in shards]
    return torch.cat([pieces[r][g] for g in range(groups)
                      for r in range(len(shards))], dim=axis)


def gather_parameter(value: torch.Tensor, param, group=None) -> torch.Tensor:
    """The full tensor of ``value`` (a split parameter's value, master or
    gradient, on every rank of the mp group; a collective call), merged
    by ``param``'s split; an unsplit parameter's ``value`` as it is."""
    group = mp_group(group)
    if not is_split(param) or group is None \
            or group.nranks == 1:
        return value
    axis = param.split_axis
    parts = _gather(value.unsqueeze(0), 0, group).unbind(0)
    return merge_shards(list(parts), axis, param.split_groups)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) in fp32: bf16 / fp16 CUDA inputs through cuBLAS's
    fp32 output, the rest in fp32."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


class _ColumnLinear(torch.autograd.Function):
    """``x @ w_i + b_i`` for each ``(w_i, b_i)`` on one input, gathered
    along the sequence first under ``sp``; backward: the input's gradient
    summed over the products and the ranks in fp32 (reduce-scatter under
    ``sp``, else all-reduce), rounded once."""

    @staticmethod
    def forward(ctx, x, group, sp, *wb):
        full = _gather(x, 1, group) if sp else x
        ws, bs = wb[0::2], wb[1::2]
        outs = []
        for w, b in zip(ws, bs):
            y = torch.matmul(full, w)
            outs.append(y + b if b is not None else y)
        ctx.group, ctx.sp, ctx.dtype = group, sp, x.dtype
        ctx.has_bias = [b is not None for b in bs]
        ctx.save_for_backward(full, *ws)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        full, *ws = ctx.saved_tensors
        x2 = _rows(full)
        dx, grads = None, []
        for w, g, has_b in zip(ws, gs, ctx.has_bias):
            if g is None:
                grads += [None, None]
                continue
            g2 = _rows(g)
            part = _mm32(g2, w.t())
            dx = part if dx is None else dx.add_(part)
            grads += [torch.matmul(x2.t(), g2).to(w.dtype),
                      g2.sum(0).to(g.dtype) if has_b else None]
        dx = dx.reshape(full.shape)
        dx = _scatter_sum(dx, 1, ctx.group) if ctx.sp \
            else _all_reduce(dx, ctx.group)
        return (dx.to(ctx.dtype), None, None, *grads)


class _RowLinear(torch.autograd.Function):
    """``x @ w`` summed over the ranks in fp32 (reduce-scatter of the
    sequence under ``sp``, else all-reduce), rounded once; backward: the
    output gradient (gathered under ``sp``) times the local weight."""

    @staticmethod
    def forward(ctx, x, w, group, sp):
        y = _mm32(_rows(x), w).reshape(*x.shape[:-1], w.shape[-1])
        y = _scatter_sum(y, 1, group) if sp else _all_reduce(y, group)
        ctx.group, ctx.sp = group, sp
        ctx.save_for_backward(x, w)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.sp:
            g = _gather(g, 1, ctx.group)
        g2 = _rows(g)
        dx = torch.matmul(g, w.t())
        dw = torch.matmul(_rows(x).t(), g2)
        return dx, dw, None, None


def column_linear(x, pairs, group=None, sp: bool = False):
    """The column-parallel products ``x @ w + b`` of one input for each
    ``(w, b)`` of ``pairs`` (``b`` may be None), split over ``group``
    (default: the mp group): under ``sp`` ``x`` is this rank's sequence
    chunk, gathered first.  One rank: ``F.linear`` each.  Returns a
    list."""
    group = mp_group(group)
    if group is None or group.nranks == 1:
        return [F.linear(x, w, b) for w, b in pairs]
    flat = [t for pair in pairs for t in pair]
    x, *flat = amp.cast("linear", x, *flat)
    return list(_ColumnLinear.apply(x, group, sp, *flat))


def _check_attr(weight_attr):
    if weight_attr is None:
        return None
    init = getattr(weight_attr, "initializer", None)
    if init is None or getattr(weight_attr, "name", None) is not None:
        raise NotImplementedError("weight_attr: the port reads a ParamAttr's "
                                  "initializer only")
    return init


def _param(init, shape, split, n, rank, generator, device) -> nn.Parameter:
    """A parameter drawn whole from ``init`` and cut to this rank's shard
    (``split``: ``(axis, groups)``, or None: replicated)."""
    full = init(shape, generator=generator, device=device)
    if split is not None and n > 1:
        full = shard_of(full, split[0], split[1], rank, n).contiguous()
    p = nn.Parameter(full)
    if split is not None:
        p.split_axis, p.split_groups = split
    return p


def _check_div(what, value, n):
    if value % max(n, 1):
        raise ValueError(f"{what} ({value}) must be divisible by mp degree "
                         f"({n})")


class VocabParallelEmbedding(nn.Module):
    """ref: ``VocabParallelEmbedding``: the ``[V, H]`` table split by rows
    over the mp group (module docstring)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *,
                 generator=None, device=None):
        super().__init__()
        self._group, self.world_size, self.rank = _coords(mp_group)
        _check_div("num_embeddings", num_embeddings, self.world_size)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.per_part = num_embeddings // self.world_size
        self.vocab_start_index = self.rank * self.per_part
        self.weight = _param(_check_attr(weight_attr) or XavierNormal(),
                             [num_embeddings, embedding_dim], (0, 1),
                             self.world_size, self.rank, generator, device)

    def forward(self, x):
        if self.world_size == 1:
            return F.embedding(x, self.weight)
        lo = self.vocab_start_index
        outside = (x < lo) | (x >= lo + self.per_part)
        out = F.embedding((x - lo).masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0)
        return _mp_allreduce(out, self._group)


class ColumnParallelLinear(nn.Module):
    """ref: ``ColumnParallelLinear``: the ``[in, out]`` weight and the bias
    split by output columns (module docstring).  ``fuse_matmul_bias``
    changes nothing (one product and one add either way)."""

    # contiguous groups of output columns, each split over the ranks
    split_groups = 1

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 gather_output: bool = True, fuse_matmul_bias: bool = False,
                 mp_group=None, name=None, *, generator=None, device=None):
        super().__init__()
        self._group, self.world_size, self.rank = _coords(mp_group)
        _check_div("out_features", out_features, self.world_size)
        if gather_output and self.split_groups > 1 and self.world_size > 1:
            raise NotImplementedError("gather_output of a grouped column "
                                      "split")
        self._in_features = in_features
        self._out_features = out_features
        self.gather_output = gather_output
        split = (1, self.split_groups)
        self.weight = _param(_check_attr(weight_attr) or XavierNormal(),
                             [in_features, out_features], split,
                             self.world_size, self.rank, generator, device)
        self.bias = _param(Constant(0.0), [out_features], (0, split[1]),
                           self.world_size, self.rank, None, device) \
            if has_bias else None

    # the input is this rank's sequence chunk (ColumnSequenceParallelLinear)
    _sp_input = False

    def forward(self, x):
        (y,) = column_linear(x, [(self.weight, self.bias)], self._group,
                             self._sp_input)
        if self.gather_output:
            y = _c_concat(y, self._group)
        return y


class RowParallelLinear(nn.Module):
    """ref: ``RowParallelLinear``: the weight split by input rows, the bias
    replicated and added after the sum over ranks (module docstring)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 generator=None, device=None):
        super().__init__()
        self._group, self.world_size, self.rank = _coords(mp_group)
        _check_div("in_features", in_features, self.world_size)
        self._in_features = in_features
        self._out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = _param(_check_attr(weight_attr) or XavierNormal(),
                             [in_features, out_features], (0, 1),
                             self.world_size, self.rank, generator, device)
        self.bias = _param(Constant(0.0), [out_features], None,
                           self.world_size, self.rank, None, device) \
            if has_bias else None

    # the output is reduce-scattered along the sequence
    # (RowSequenceParallelLinear)
    _sp_output = False

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _c_split(x, self._group)
        x, w = amp.cast("linear", x, self.weight)
        y = _RowLinear.apply(x, w, self._group, self._sp_output)
        return y + self.bias.to(y.dtype) if self.bias is not None else y


class _ParallelCE(torch.autograd.Function):
    """Softmax cross entropy of ``[N, V/n]`` logits split over ``group``
    (two passes); the loss is 0 at ``ignore_index``."""

    @staticmethod
    def forward(ctx, logits, label, start, ignore_index, group):
        x = logits.float()
        m = x.amax(dim=-1)
        _collective_max(m, group)
        e = (x - m[:, None]).exp_()
        s = _all_reduce(e.sum(dim=-1), group)
        local = label - start
        mine = (local >= 0) & (local < x.shape[-1])
        safe = local.clamp(0, x.shape[-1] - 1)
        picked = torch.gather(x, -1, safe[:, None]).squeeze(-1) - m
        picked = _all_reduce(torch.where(mine, picked, 0.0), group)
        valid = label != ignore_index
        loss = torch.where(valid, s.log() - picked, 0.0)
        e.div_(s[:, None])
        ctx.save_for_backward(e, safe, mine, valid)
        ctx.dtype = logits.dtype
        return loss.to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        p, safe, mine, valid = ctx.saved_tensors
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows[mine], safe[mine]] -= 1.0
        p.mul_(torch.where(valid, g.float(), 0.0)[:, None])
        return p.to(ctx.dtype), None, None, None, None


def _collective_max(t, group):
    _collective_entry("all_reduce", group, tensor=t)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=group.process_group)


class ParallelCrossEntropy(nn.Module):
    """ref: ``ParallelCrossEntropy``: per-row softmax cross entropy of
    logits whose last axis is split over the mp group (``reduction
    "none"``; 0 at ``ignore_index``), the two-pass softmax of the module
    docstring.  Under amp the logits go up to fp32 (black-listed op)."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self._group, self.world_size, self.rank = _coords(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if self.world_size == 1:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index,
                                   _vocab_sharded=True)
        (logits,) = amp.cast("cross_entropy", input)
        lead = logits.shape[:-1]
        v = logits.shape[-1]
        li = label.long()
        if li.dim() == logits.dim() and li.shape[-1] == 1:
            li = li.squeeze(-1)
        loss = _ParallelCE.apply(logits.reshape(-1, v), li.reshape(-1),
                                 self.rank * v, self.ignore_index,
                                 self._group)
        return loss.reshape(lead)
