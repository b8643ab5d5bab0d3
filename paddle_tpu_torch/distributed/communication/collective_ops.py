"""Collective communication ops; counterpart of
``paddle_tpu/distributed/communication/collective_ops.py``.

Every op runs on ``torch.distributed`` over the group's process group
(NCCL on the card, gloo on the CPU), one process per rank.  Each
computes, on each rank's own tensor, what the JAX package's SPMD mode
(its lax collectives inside ``shard_map``) computes per rank, in place
where that mode assigns in place.  The JAX package's eager mode, where
a single controller's arrays are already global and a reduction is the
identity, has no counterpart: here every tensor is one rank's.  As
there, ``reduce`` and ``gather`` leave their result on every rank (a
legal strengthening of the reference's contract), and ``send``/``recv``
address peers by rank.  Peers and roots are global ranks, or ranks in
the group when they are not members (Paddle's convention).

``sync_op=False`` returns a work handle whose ``wait()`` waits on the
``torch.distributed`` work (on the card: makes the current stream wait
for the communication stream).  ``all_reduce`` is differentiable with
the identity backward of the reference's ``c_allreduce_sum_grad`` (each
rank's loss, each rank's gradient), as a ``torch.autograd.Function``
that reduces in place; the other ops are not differentiable.

Each op enters through :func:`_collective_entry`: the ``collective``
fault point of ``resilience.faults``, then the fingerprint cross-check of
``FLAGS_collective_sanitizer`` (``sanitizer.py``), both before the
launch.  ``use_calc_stream`` is accepted and changes nothing (torch
orders the streams itself).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .group import Group, ReduceOp, _resolve_group, torch_op

__all__ = ["all_reduce", "reduce", "all_gather", "gather",
           "all_gather_object", "broadcast", "broadcast_object_list",
           "scatter", "scatter_object_list", "reduce_scatter", "alltoall",
           "alltoall_single", "send", "recv", "isend", "irecv", "P2POp",
           "batch_isend_irecv", "barrier", "wait"]


class _Work:
    """An async work handle (ref: ProcessGroup::Task).  ``wait()`` waits
    on the torch work, then runs what the op does once its data is in
    (filling an output list)."""

    def __init__(self, work=None, post=None):
        self._work = work
        self._post = post

    def wait(self) -> bool:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._post is not None:
            post, self._post = self._post, None
            post()
        return True

    def is_completed(self) -> bool:
        return self._work is None or self._work.is_completed()


def _finish(work, sync_op: bool, post=None) -> _Work:
    w = _Work(work, post)
    if sync_op:
        w.wait()
    return w


def _collective_entry(op_name: str, g, tensor=None, reduce_op=None):
    """Host-side entry shared by every collective below: the resilience
    fault point (a scheduled crash/stall models a rank dying inside
    NCCL; truncate/corrupt queue payload damage), then the
    ``FLAGS_collective_sanitizer`` cross-check, which raises
    ``CollectiveMismatchError`` BEFORE the launch when ranks disagree on
    order/shape/dtype/reduce op instead of hanging in NCCL.  Delegating
    wrappers (reduce -> all_reduce, gather -> all_gather, isend/irecv ->
    send/recv) are not hooked: one entry, one fingerprint."""
    from ...resilience.faults import maybe_fault
    maybe_fault("collective", op=op_name)
    from .sanitizer import observe_collective
    observe_collective(op_name, g, tensor=tensor, reduce_op=reduce_op)


class _AllReduce(torch.autograd.Function):
    """In-place all-reduce whose backward is the identity."""

    @staticmethod
    def forward(ctx, x, op, pg):
        dist.all_reduce(x, op=op, group=pg)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _member(g: Group) -> bool:
    return g.process_group is not None


# ---------------------------------------------------------------------------
# all_reduce / reduce
# ---------------------------------------------------------------------------

def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op: bool = True,
               use_calc_stream: bool = False):
    """In-place reduction over the group's ranks (ref:
    ``communication/all_reduce.py``).  Under autograd (a tensor that
    requires grad, grad mode on) it runs synchronously and records the
    identity backward."""
    g = _resolve_group(group)
    if not _member(g):
        return _Work()
    _collective_entry("all_reduce", g, tensor=tensor, reduce_op=op)
    top = torch_op(op)
    if torch.is_grad_enabled() and tensor.requires_grad:
        _AllReduce.apply(tensor, top, g.process_group)
        return _Work()
    return _finish(dist.all_reduce(tensor, op=top, group=g.process_group,
                                   async_op=not sync_op), sync_op)


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group=None,
           sync_op: bool = True, use_calc_stream: bool = False):
    """ref: ``communication/reduce.py`` — the result is valid on ``dst``;
    every rank receives it, as in the reference."""
    return all_reduce(tensor, op=op, group=group, sync_op=sync_op)


# ---------------------------------------------------------------------------
# all_gather / gather
# ---------------------------------------------------------------------------

def all_gather(tensor_list: Optional[List], tensor=None, group=None,
               sync_op: bool = True, use_calc_stream: bool = False):
    """ref: ``communication/all_gather.py`` — fills ``tensor_list`` with
    every rank's tensor (in group rank order).  Functional form:
    ``all_gather(None, t)`` or ``all_gather(t)`` returns the dim-0
    concatenation."""
    if tensor is None and not isinstance(tensor_list, list):
        tensor_list, tensor = None, tensor_list
    g = _resolve_group(group)
    if not _member(g):
        return _Work()
    _collective_entry("all_gather", g, tensor=tensor)
    t = tensor.contiguous()
    if t.dim() == 0:
        t = t.reshape(1)
    n = g.nranks
    cat = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    from ..parallel import all_gather_single
    if tensor_list is None:
        all_gather_single(cat, t, group=g.process_group)
        return cat

    def fill():
        del tensor_list[:]
        tensor_list.extend(c.reshape(tensor.shape) for c in cat.chunk(n))
    return _finish(all_gather_single(cat, t, group=g.process_group,
                                     async_op=not sync_op), sync_op, fill)


def gather(tensor, gather_list=None, dst: int = 0, group=None,
           sync_op: bool = True, use_calc_stream: bool = False):
    """ref: ``communication/gather.py`` — every rank's tensor collected
    at ``dst``; every rank receives the list, as in the reference."""
    if gather_list is None:
        gather_list = []
    return all_gather(gather_list, tensor, group=group, sync_op=sync_op)


def all_gather_object(object_list: List, obj, group=None):
    """Every rank's picklable ``obj``, in group rank order."""
    g = _resolve_group(group)
    if not _member(g):
        return
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.process_group)
    object_list[:] = out


# ---------------------------------------------------------------------------
# broadcast / scatter
# ---------------------------------------------------------------------------

def broadcast(tensor, src: int = 0, group=None, sync_op: bool = True,
              use_calc_stream: bool = False):
    """ref: ``communication/broadcast.py`` — ``src``'s tensor, in place
    on every rank."""
    g = _resolve_group(group)
    if not _member(g):
        return _Work()
    _collective_entry("broadcast", g, tensor=tensor)
    return _finish(dist.broadcast(tensor, src=g.global_rank(src),
                                  group=g.process_group,
                                  async_op=not sync_op), sync_op)


def broadcast_object_list(object_list: List, src: int = 0, group=None):
    """``src``'s picklable objects, in place in every rank's list."""
    g = _resolve_group(group)
    if _member(g):
        dist.broadcast_object_list(object_list, src=g.global_rank(src),
                                   group=g.process_group)
    return object_list


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op: bool = True, use_calc_stream: bool = False):
    """ref: ``communication/scatter.py`` — ``src``'s ``tensor_list``
    scattered one chunk per rank, in place into ``tensor``.  The
    reference's form without a list (``src``'s ``tensor`` stacked along
    dim 0, a chunk of another shape) raises ``NotImplementedError``."""
    if tensor_list is None:
        raise NotImplementedError("scatter without tensor_list: pass src's "
                                  "chunks as tensor_list")
    g = _resolve_group(group)
    if not _member(g):
        return _Work()
    _collective_entry("scatter", g, tensor=tensor)
    gsrc = g.global_rank(src)
    chunks = [t.contiguous() for t in tensor_list] \
        if dist.get_rank() == gsrc else None
    return _finish(dist.scatter(tensor, chunks, src=gsrc,
                                group=g.process_group,
                                async_op=not sync_op), sync_op)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """``src``'s ``in_object_list[r]`` into rank r's ``out_object_list``."""
    g = _resolve_group(group)
    if not _member(g):
        return
    gsrc = g.global_rank(src)
    out = [None]
    dist.scatter_object_list(
        out, in_object_list if dist.get_rank() == gsrc else None,
        src=gsrc, group=g.process_group)
    out_object_list[:] = out


# ---------------------------------------------------------------------------
# reduce_scatter
# ---------------------------------------------------------------------------

def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op: bool = True, use_calc_stream: bool = False):
    """ref: ``communication/reduce_scatter.py``.  List form: rank r's
    ``tensor`` receives the reduction of every rank's ``tensor_list[r]``.
    Functional form ``reduce_scatter(x)``: returns this rank's dim-0
    chunk of the reduction of every rank's ``x``."""
    g = _resolve_group(group)
    if not _member(g):
        return _Work()
    _collective_entry("reduce_scatter", g,
                      tensor=None if (tensor_list is not None
                                      or tensor is None) else tensor,
                      reduce_op=op)
    top = torch_op(op)
    if tensor_list is not None:
        return _finish(dist.reduce_scatter(
            tensor, [t.contiguous() for t in tensor_list], op=top,
            group=g.process_group, async_op=not sync_op), sync_op)
    n = g.nranks
    if tensor.shape[0] % n:
        raise ValueError(f"reduce_scatter payload dim 0 ({tensor.shape[0]}) "
                         f"is not divisible by the group size ({n})")
    out = torch.empty((tensor.shape[0] // n,) + tuple(tensor.shape[1:]),
                      dtype=tensor.dtype, device=tensor.device)
    from ..parallel import reduce_scatter_single
    reduce_scatter_single(out, tensor.contiguous(), op=top,
                          group=g.process_group)
    return out


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------

def alltoall(out_tensor_list, in_tensor_list=None, group=None,
             sync_op: bool = True, use_calc_stream: bool = False):
    """ref: ``communication/all_to_all.py`` — rank r's
    ``out_tensor_list[s]`` is rank s's ``in_tensor_list[r]``.  With one
    list it is the input, and the outputs are returned."""
    g = _resolve_group(group)
    if in_tensor_list is None:
        in_tensor_list, out_tensor_list = out_tensor_list, None
    if not _member(g):
        return _Work()
    _collective_entry("alltoall", g,
                      tensor=in_tensor_list[0] if in_tensor_list else None)
    ins = [t.contiguous() for t in in_tensor_list]
    outs = [torch.empty_like(t) for t in ins]
    if out_tensor_list is None:
        dist.all_to_all(outs, ins, group=g.process_group)
        return outs

    def fill():
        out_tensor_list[:] = outs
    return _finish(dist.all_to_all(outs, ins, group=g.process_group,
                                   async_op=not sync_op), sync_op, fill)


def alltoall_single(out_tensor, in_tensor=None,
                    in_split_sizes=None, out_split_sizes=None,
                    group=None, sync_op: bool = True,
                    use_calc_stream: bool = False):
    """ref: ``communication/all_to_all.py`` alltoall_single.  Equal
    splits of dim 0 by default, as in the reference; given split sizes
    are honoured.  With one tensor it is the input, and the output is
    returned."""
    g = _resolve_group(group)
    if in_tensor is None:
        in_tensor, out_tensor = out_tensor, None
    if not _member(g):
        return _Work()
    _collective_entry("alltoall_single", g, tensor=in_tensor)
    if in_split_sizes is None and in_tensor.shape[0] % g.nranks:
        raise ValueError(f"alltoall_single payload dim 0 "
                         f"({in_tensor.shape[0]}) is not divisible by the "
                         f"group size ({g.nranks})")
    functional = out_tensor is None
    if functional:
        rows = sum(out_split_sizes) if out_split_sizes is not None \
            else in_tensor.shape[0]
        out_tensor = torch.empty((rows,) + tuple(in_tensor.shape[1:]),
                                 dtype=in_tensor.dtype,
                                 device=in_tensor.device)
    work = dist.all_to_all_single(
        out_tensor, in_tensor.contiguous(), out_split_sizes, in_split_sizes,
        group=g.process_group, async_op=not (sync_op or functional))
    if functional:
        return out_tensor
    return _finish(work, sync_op)


# ---------------------------------------------------------------------------
# point to point
# ---------------------------------------------------------------------------

def send(tensor, dst: int = 0, group=None, sync_op: bool = True,
         use_calc_stream: bool = False):
    """Send ``tensor`` to rank ``dst``."""
    g = _resolve_group(group)
    if not _member(g):
        return _Work()
    _collective_entry("send", g, tensor=tensor)
    peer = g.global_rank(dst)
    if sync_op:
        dist.send(tensor.contiguous(), peer, group=g.process_group)
        return _Work()
    return _Work(dist.isend(tensor.contiguous(), peer,
                            group=g.process_group))


def recv(tensor, src: int = 0, group=None, sync_op: bool = True,
         use_calc_stream: bool = False):
    """Receive into ``tensor`` (contiguous) from rank ``src``."""
    g = _resolve_group(group)
    if not _member(g):
        return _Work()
    _collective_entry("recv", g, tensor=tensor)
    peer = g.global_rank(src)
    if sync_op:
        dist.recv(tensor, peer, group=g.process_group)
        return _Work()
    return _Work(dist.irecv(tensor, peer, group=g.process_group))


def isend(tensor, dst: int = 0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src: int = 0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """ref: ``communication/batch_isend_irecv.py`` P2POp: ``op`` is
    ``isend``/``send`` or ``irecv``/``recv``."""

    def __init__(self, op, tensor, peer: int, group=None):
        if op not in (isend, send, irecv, recv):
            raise ValueError("op must be isend, send, irecv or recv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = _resolve_group(group)


def batch_isend_irecv(p2p_op_list: Sequence[P2POp]):
    """Launch every send and receive of the list together; returns their
    work handles."""
    if not p2p_op_list:
        return []
    first = p2p_op_list[0]
    _collective_entry("batch_isend_irecv", first.group, tensor=first.tensor)
    ops = [dist.P2POp(dist.isend if p.op in (isend, send) else dist.irecv,
                      p.tensor, p.group.global_rank(p.peer),
                      group=p.group.process_group)
           for p in p2p_op_list]
    return [_Work(w) for w in dist.batch_isend_irecv(ops)]


# ---------------------------------------------------------------------------
# barrier / sync
# ---------------------------------------------------------------------------

def barrier(group=None):
    """ref: ``communication/barrier.py``."""
    g = _resolve_group(group)
    if not _member(g):
        return
    _collective_entry("barrier", g)
    dist.barrier(group=g.process_group)


def wait(tensor, group=None, use_calc_stream: bool = True):
    """Block until the work queued on ``tensor``'s device is done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
