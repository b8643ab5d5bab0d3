"""``init_parallel_env``, ``DataParallel`` and ``spawn``; counterpart of
``paddle_tpu/distributed/parallel.py``.

The JAX package drives every device from one process: its gradients are
global arrays and XLA inserts the reduction into the jitted step, so its
``DataParallel`` only marks the model.  The port runs one process per
card, as upstream Paddle on GPUs, so ``DataParallel`` reduces the
gradients itself, with one bucketed reducer written on
``torch.distributed`` (:class:`_Reducer`, upstream's ``EagerReducer``):

* the parameters are packed, in reverse order, into flat buckets of one
  dtype (``last_comm_buffer_size`` MB for the first one filled, then
  ``comm_buffer_size`` MB each), each slot aligned to 256 bytes and each
  bucket padded to a multiple of the group size; the parameters become
  views of the bucket's flat ``param_buf``, which the group's first rank
  broadcasts when ``DataParallel`` is built;
* as backward finishes each parameter's gradient
  (``register_post_accumulate_grad_hook``), the gradient is copied into
  its slot of the bucket's flat ``grad_buf`` and becomes a view of it;
  a full bucket launches an async average over the group (buckets launch
  in bucket order, the same on every rank);
* the end of backward (an autograd engine callback) fills the slots of
  unused parameters (with zeros, or with what they accumulated outside
  the sync), launches the rest and waits on every bucket's work, so the
  optimizer's step reads averaged gradients (on the card the wait makes
  the compute stream wait for NCCL's; the host does not block).

ZeRO stages 1 and 2 (``fleet/meta_parallel/sharding``) shard the
optimizer over the same buckets: stage 1 averages a bucket and each rank
updates its own shard, stage 2 reduce-scatters the bucket instead (the
reducer's ``mode``).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import weakref
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from . import env as _env
from .communication.group import ReduceOp, _resolve_group
from .communication.store import TCPStore
from .env import ParallelEnv

__all__ = ["init_parallel_env", "DataParallel", "spawn"]

# the process group's timeout: a collective that waits longer fails
TIMEOUT_S = 300.0
# set by the launcher and spawn when they serve PADDLE_MASTER's store
STORE_SERVED_ENV = "PADDLE_LAUNCHER_STORE"
_MB = 1 << 20
_ALIGN_BYTES = 256


def serve_store(world_size: int) -> TCPStore:
    """A rendezvous store on a free local port, for the ranks a launcher
    starts (they connect to it as clients: ``STORE_SERVED_ENV``)."""
    return TCPStore("127.0.0.1", 0, is_master=True, world_size=world_size,
                    timeout=TIMEOUT_S)


def init_parallel_env(*, device=None) -> ParallelEnv:
    """ref: ``paddle.distributed.init_parallel_env``.  Joins this process
    to the group the launcher's environment describes
    (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``):
    NCCL on ``cuda:<FLAGS_selected_gpus>`` by default, which raises
    without a card; gloo on the CPU when the caller passes
    ``device="cpu"``.  A single process without ``PADDLE_MASTER`` makes
    a world of one.  Calling it again changes nothing."""
    if _env.is_initialized():
        return ParallelEnv()
    e = ParallelEnv()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for NCCL; pass "
                               "device='cpu' to run the group on gloo")
        dev = torch.device("cuda", e.device_id if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    if e.master:
        host, _, port = e.master.rpartition(":")
    elif e.world_size == 1:
        host, port = "127.0.0.1", 0
    else:
        raise RuntimeError("PADDLE_MASTER is not set for a world of "
                           f"{e.world_size}: start the ranks with python -m "
                           "paddle_tpu_torch.distributed.launch")
    # the launcher (and spawn) serve the store themselves: then every rank
    # is a client, and no rank races another process for the port
    served = os.environ.get(STORE_SERVED_ENV) == "1"
    store = TCPStore(host, int(port), is_master=e.rank == 0 and not served,
                     world_size=e.world_size, timeout=TIMEOUT_S)
    dist.init_process_group(backend, store=store.torch_store, rank=e.rank,
                            world_size=e.world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _env._mark_initialized(store, backend, dev)
    return e


# ---------------------------------------------------------------------------
# the bucketed reducer
# ---------------------------------------------------------------------------

# ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` under the names
# newer torch gives them
all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _weak_hook(method):
    """A tensor hook that calls ``method`` through a weak reference.  A
    tensor keeps its hooks on its C++ side, where the garbage collector
    cannot see the cycle parameter -> hook -> reducer -> parameter, so a
    strong reference would keep a deleted model's reducer and buffers
    alive."""
    ref = weakref.WeakMethod(method)

    def hook(*args):
        m = ref()
        return None if m is None else m(*args)
    return hook


# id(state dict) -> (weak reference to it, [(prefix, owner)]): the
# modules and optimizers whose ``state_dict()`` made a dict
_SD_OWNERS: Dict[int, tuple] = {}


def _remember_checkpoint_owner(sd, prefix: str, owner) -> None:
    """Record, outside the dict (which pickles as before), that
    ``owner`` (a module, or an optimizer) made ``sd`` under ``prefix``,
    so ``distributed.checkpoint`` finds the live state behind each
    entry: a split parameter's boxes, a ZeRO shard.  ``sd`` must take a
    weak reference (an ``OrderedDict`` does)."""
    entry = _SD_OWNERS.get(id(sd))
    if entry is None or entry[0]() is not sd:
        key = id(sd)
        ref = weakref.ref(sd, lambda _r, key=key: _SD_OWNERS.pop(key, None))
        entry = _SD_OWNERS[key] = (ref, [])
    entry[1].append((prefix, owner))


def _mark_checkpoint_owner(module: torch.nn.Module) -> None:
    """Make every ``module.state_dict()`` remember ``module``
    (``_remember_checkpoint_owner``).  The wrappers call it on the model
    they wrap."""
    if getattr(module, "_ckpt_owner_marked", False):
        return
    module._ckpt_owner_marked = True
    module.register_state_dict_post_hook(
        lambda mod, sd, prefix, local_metadata:
        _remember_checkpoint_owner(sd, prefix, mod))


def _checkpoint_owners(sd) -> list:
    """``[(prefix, owner)]`` that made the state dict ``sd`` (empty for
    any other dict)."""
    entry = _SD_OWNERS.get(id(sd))
    return list(entry[1]) if entry is not None and entry[0]() is sd else []


def reducer_of(p) -> Optional["_Reducer"]:
    """The reducer whose buckets hold parameter ``p`` (the sharded
    optimizers find their parameters' buckets this way)."""
    return getattr(p, "_dist_reducer", None)


def _slots(params, nranks: int):
    """Each parameter's offset in a flat buffer of their dtype, every slot
    starting on a ``_ALIGN_BYTES`` boundary, and the buffer's length
    padded to a multiple of ``nranks`` aligned units."""
    align = max(_ALIGN_BYTES // params[0].element_size(), 1)
    offsets, o = [], 0
    for p in params:
        offsets.append(o)
        o += -(-p.numel() // align) * align
    unit = align * nranks
    return offsets, -(-o // unit) * unit


class _Bucket:
    """Flat parameter and gradient buffers of one dtype; ``offsets[i]``
    is parameter i's slot."""

    def __init__(self, params: List[torch.Tensor], nranks: int, key):
        self.params = params
        self.key = key
        p0 = params[0]
        self.dtype, self.device = p0.dtype, p0.device
        self.offsets, self.numel = _slots(params, nranks)
        self.param_buf = torch.zeros(self.numel, dtype=self.dtype,
                                     device=self.device)
        self.grad_buf = torch.zeros_like(self.param_buf)
        self.shard_grad: Optional[torch.Tensor] = None
        with torch.no_grad():
            for p, off in zip(params, self.offsets):
                view = self.param_buf[off:off + p.numel()]
                view.copy_(p.detach().reshape(-1))
                p.data = view.view(p.shape)
        self.pending: set = set()
        self.work = None

    def slot(self, i: int) -> torch.Tensor:
        off = self.offsets[i]
        return self.grad_buf[off:off + self.params[i].numel()]

    def aliased(self) -> bool:
        base = self.param_buf.data_ptr()
        size = self.param_buf.element_size()
        return all(p.dtype == self.dtype and p.device == self.device
                   and p.data_ptr() == base + off * size
                   for p, off in zip(self.params, self.offsets))


class _Reducer:
    """Bucketed gradient averaging over ``group`` (module docstring).
    ``mode`` is ``"all_reduce"`` (DataParallel, ZeRO stage 1) or
    ``"reduce_scatter"`` (stage 2: each rank receives the average of its
    shard in ``bucket.shard_grad``; ``grad_buf`` keeps the rank's own
    gradient)."""

    def __init__(self, params, group, bucket_bytes: float,
                 first_bucket_bytes: float):
        self.params, seen = [], set()
        for p in params:
            if p.requires_grad and id(p) not in seen:
                seen.add(id(p))
                self.params.append(p)
        for p in self.params:
            if reducer_of(p) is not None:
                raise ValueError("a parameter is already in a DataParallel "
                                 "or group-sharded wrapper")
        self.group = group
        self.nranks = group.nranks
        self.bucket_bytes = float(bucket_bytes)
        self.first_bucket_bytes = float(first_bucket_bytes)
        self.mode = "all_reduce"
        self.sync_enabled = True
        self._key_fn = None
        self._armed = False
        self._next = 0
        self._build()
        self._hooks = [
            p.register_post_accumulate_grad_hook(_weak_hook(self._on_grad))
            for p in self.params]
        for p in self.params:
            p._dist_reducer = self

    # -- layout ----------------------------------------------------------
    def _build(self) -> None:
        """One open bucket per (dtype, device, key), filled in reverse
        parameter order and closed when the next parameter would pass
        the size limit (the first bucket closed has the small limit);
        the buckets launch in the order they closed, the open ones
        last."""
        self.buckets = []        # the old gradient buffers go first
        buckets, open_ = [], {}
        for p in reversed(self.params):
            key = (p.dtype, p.device,
                   self._key_fn(p) if self._key_fn else None)
            nbytes = p.numel() * p.element_size()
            cur, size = open_.get(key, ([], 0))
            limit = self.bucket_bytes if buckets else self.first_bucket_bytes
            if cur and size + nbytes > limit:
                buckets.append(_Bucket(cur, self.nranks, key))
                cur, size = [], 0
            open_[key] = (cur + [p], size + nbytes)
        buckets += [_Bucket(cur, self.nranks, key)
                    for key, (cur, _) in open_.items()]
        self.buckets = buckets
        self._slot = {}
        for b in buckets:
            for i, p in enumerate(b.params):
                self._slot[id(p)] = (b, i)
        self._shard_buffers()

    def _shard_buffers(self) -> None:
        for b in self.buckets:
            b.shard_grad = torch.zeros(
                b.numel // self.nranks, dtype=b.dtype, device=b.device) \
                if self.mode == "reduce_scatter" else None

    def set_mode(self, mode: str) -> None:
        if mode not in ("all_reduce", "reduce_scatter"):
            raise ValueError(f"unknown reducer mode {mode!r}")
        self.mode = mode
        self._shard_buffers()

    def split_by(self, key_fn) -> None:
        """Make every bucket hold one value of ``key_fn(param)`` (the
        sharded optimizers' decay groups) as ``bucket.key[2]``: the
        buckets are rebuilt only if one mixes two values."""
        self._key_fn = key_fn
        keys = [{key_fn(p) for p in b.params} for b in self.buckets]
        if any(len(k) > 1 for k in keys):
            self._build()
            return
        for b, (k,) in zip(self.buckets, keys):
            b.key = b.key[:2] + (k,)

    def sync_layout(self) -> None:
        """Rebuild the buckets if a parameter no longer views its slot
        (``amp.decorate`` after wrapping casts a parameter in place)."""
        if not all(b.aliased() for b in self.buckets):
            self._build()

    def detach(self) -> None:
        """Take the reducer off its parameters: their gradient hooks go,
        each parameter (and gradient) gets storage of its own again, and
        another wrapper may take them (``Engine.tune``'s trials)."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
        with torch.no_grad():
            for p in self.params:
                p.data = p.data.clone()
                if p.grad is not None:
                    p.grad = p.grad.clone()
                del p._dist_reducer
        self.buckets, self._slot = [], {}

    # -- backward --------------------------------------------------------
    def _on_grad(self, p) -> None:
        if not self.sync_enabled:
            return
        if not self._armed:
            self._armed = True
            self._next = 0
            for b in self.buckets:
                b.pending = set(range(len(b.params)))
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finalize)
        b, i = self._slot[id(p)]
        self._take(b, i)
        b.pending.discard(i)
        if not b.pending:
            self._launch_ready()

    @staticmethod
    def _take(b: _Bucket, i: int) -> None:
        """Parameter i's gradient into its slot; the gradient becomes a
        view of the slot (zeros when the parameter has none)."""
        p, slot = b.params[i], b.slot(i)
        g = p.grad
        if g is None:
            slot.zero_()
        elif g.data_ptr() != slot.data_ptr():
            slot.copy_(g.reshape(-1))
        p.grad = slot.view(p.shape)

    def _launch_ready(self) -> None:
        while self._next < len(self.buckets) and \
                not self.buckets[self._next].pending:
            self._launch(self.buckets[self._next])
            self._next += 1

    def _launch(self, b: _Bucket) -> None:
        from .communication.collective_ops import _collective_entry
        pg = self.group.process_group
        if self.mode == "all_reduce":
            _collective_entry("all_reduce", self.group, tensor=b.grad_buf,
                              reduce_op=ReduceOp.AVG)
            b.work = dist.all_reduce(b.grad_buf, op=dist.ReduceOp.AVG,
                                     group=pg, async_op=True)
        else:
            _collective_entry("reduce_scatter", self.group,
                              tensor=b.grad_buf, reduce_op=ReduceOp.AVG)
            b.work = reduce_scatter_single(
                b.shard_grad, b.grad_buf, op=dist.ReduceOp.AVG, group=pg,
                async_op=True)

    def _finalize(self) -> None:
        self._armed = False
        for b in self.buckets[self._next:]:
            for i in sorted(b.pending):
                self._take(b, i)      # unused in this backward
            b.pending.clear()
        self._launch_ready()
        for b in self.buckets:
            if b.work is not None:
                b.work.wait()
                b.work = None


# ---------------------------------------------------------------------------
# ZeRO stage 3: parameters sharded between steps, gathered by segment
# ---------------------------------------------------------------------------

class _ShardFlat:
    """The parameters of one key (dtype, device, weight decay) of a
    stage-3 segment, in ``_Bucket``'s aligned slots.  Between steps this
    rank holds elements ``[lo, hi)`` of the flat: ``param_shard`` (the
    values) and, after a backward, ``shard_grad`` (the averaged
    gradient).  While the segment is gathered the flat exists in full
    (``full``) and its parameters view it."""

    def __init__(self, params, values, nranks: int, rank: int, key):
        self.params, self.key = params, key
        self.dtype, self.device = values[0].dtype, values[0].device
        self.shapes = [v.shape for v in values]
        self.offsets, self.numel = _slots(values, nranks)
        n = self.numel // nranks
        self.lo, self.hi = rank * n, (rank + 1) * n
        self.full = torch.zeros(self.numel, dtype=self.dtype,
                                device=self.device)
        for v, off in zip(values, self.offsets):
            self.full[off:off + v.numel()].copy_(v.reshape(-1))
        self.param_shard: Optional[torch.Tensor] = None
        self.shard_grad: Optional[torch.Tensor] = None
        self.has_grad = False
        self.empty = torch.empty(0, dtype=self.dtype, device=self.device)
        self.work = self.grad_full = self.grad_add = None

    def view(self, full: torch.Tensor) -> None:
        for p, off, shape in zip(self.params, self.offsets, self.shapes):
            p.data = full[off:off + shape.numel()].view(shape)
        self.full = full

    def release(self) -> None:
        for p in self.params:
            p.data = self.empty
        self.full = None


class _Segment:
    """One unit of the forward (a layer of a ``ModuleList``, or the root:
    every parameter outside the layers) and its flats."""

    def __init__(self, name: str, module, flats: List[_ShardFlat]):
        self.name, self.module, self.flats = name, module, flats
        self.gathered = False
        self.pending: set = set()


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []


class _ShardedReducer:
    """ZeRO stage 3 over ``group`` (``GroupShardedStage3``).  The model's
    trainable parameters are laid out by **segment**: each element of an
    ``nn.ModuleList`` (a decoder layer or block) is one, and every
    parameter outside them, or shared by two of them, belongs to the
    root segment (embeddings, final norm, head; a head tied to the
    embedding is then one parameter of one segment).  Each segment holds
    one flat per key (dtype, device, decay) in aligned slots, and this
    rank keeps only its ``1/n`` shard of each flat between steps; every
    parameter is then an empty tensor of its dtype.

    * Forward: the root is gathered (all-gather) when the wrapper's
      forward starts; a layer is gathered by a forward pre-hook and freed
      by a forward hook, which also hooks the layer's outputs.
    * Backward: the first gradient reaching a layer's outputs gathers it
      again; a recomputation inside the backward (``fleet.recompute``)
      finds it gathered and keeps it.  Once every parameter of a segment
      has its gradient (``register_post_accumulate_grad_hook``; a tied
      parameter's fires after both uses), the segment's gradients are
      copied into a full flat and reduce-scattered (averaged) into this
      rank's ``shard_grad``, asynchronously, in a fixed order (layers
      last to first, then the root; a segment ready early waits for its
      turn), and the gradients and parameters are freed; the previous
      segment's reduce-scatter is waited on first, so at most one is in
      flight.  The end of the backward (an engine callback) reduce-
      scatters segments with unused parameters (their gradients zero)
      and waits.  A second backward before ``clear`` adds its gradient
      to the first.

    ``gathers`` and ``reduce_scatters`` count the collectives (one a
    flat)."""

    mode = "stage3"

    def __init__(self, model: torch.nn.Module, group, sync: bool):
        self.params, seen = [], set()
        for p in model.parameters():
            if p.requires_grad and id(p) not in seen:
                seen.add(id(p))
                self.params.append(p)
        for p in self.params:
            if reducer_of(p) is not None:
                raise ValueError("a parameter is already in a DataParallel "
                                 "or group-sharded wrapper")
        self.group = group
        self.nranks, self.rank = group.nranks, group.rank
        self._key_fn = None
        self.frozen = False          # the sharded optimizer holds state
        self.gathers = self.reduce_scatters = 0
        self._armed = False
        self._next = 0
        self._inflight: List[_Segment] = []
        self._units = self._find_units(model)
        self._build({id(p): p.detach() for p in self.params}, sync)
        for name, m, _ in self._units:
            if m is not None:
                m.register_forward_pre_hook(
                    lambda mod, args, name=name: self._pre_forward(name))
                m.register_forward_hook(
                    lambda mod, args, out, name=name:
                    self._post_forward(name, out))
        self._hooks = [
            p.register_post_accumulate_grad_hook(_weak_hook(self._on_grad))
            for p in self.params]
        for p in self.params:
            p._dist_reducer = self

    # -- layout ----------------------------------------------------------
    def _find_units(self, model):
        """``(name, module, params)`` of the root (module None) and of
        every element of the outermost ``ModuleList``s."""
        layers = []
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.ModuleList) and not any(
                    name.startswith(u + ".") for u, _ in layers):
                layers += [(f"{name}.{i}", c) for i, c in enumerate(m)]
        trainable = {id(p) for p in self.params}
        owners: Dict[int, List[int]] = {}
        for k, (_, m) in enumerate(layers):
            for p in m.parameters():
                if id(p) in trainable:
                    owners.setdefault(id(p), []).append(k)
        units = [("root", None, [p for p in self.params
                                 if len(owners.get(id(p), ())) != 1])]
        units += [(name, m, [p for p in m.parameters()
                             if owners.get(id(p)) == [k]])
                  for k, (name, m) in enumerate(layers)]
        return [u for u in units if u[2]]

    def _build(self, values: Dict[int, torch.Tensor], sync: bool) -> None:
        from .communication.collective_ops import broadcast
        self.segments, self.buckets = [], []
        self._seg_of, self._by_name = {}, {}
        for name, m, params in self._units:
            keyed: Dict[tuple, list] = {}
            for p in params:
                v = values[id(p)]
                key = (v.dtype, v.device,
                       self._key_fn(p) if self._key_fn else None)
                keyed.setdefault(key, []).append(p)
            flats = []
            for key, ps in keyed.items():
                f = _ShardFlat(ps, [values[id(p)] for p in ps], self.nranks,
                               self.rank, key)
                if sync:
                    broadcast(f.full, src=self.group.ranks[0],
                              group=self.group)
                f.param_shard = f.full[f.lo:f.hi].clone()
                f.release()
                flats.append(f)
            seg = _Segment(name, m, flats)
            self.segments.append(seg)
            self._by_name[name] = seg
            self.buckets += flats
            for p in params:
                self._seg_of[id(p)] = seg
        # reduce-scatter order: the layers last to first, then the root
        self._order = [s for s in reversed(self.segments)
                       if s.module is not None] + \
            [s for s in self.segments if s.module is None]

    def _values(self) -> Dict[int, torch.Tensor]:
        """Every parameter's full value (a collective call), cast to the
        dtype the parameter has now."""
        want = {id(p): p.dtype for p in self.params}
        out = {}
        for seg in self.segments:
            self.gather(seg)
            for p in (p for f in seg.flats for p in f.params):
                out[id(p)] = p.detach().to(want[id(p)], copy=True)
            self.free(seg)
        return out

    def _relayout(self) -> None:
        if self.frozen:
            raise RuntimeError("the stage-3 layout changed (a parameter's "
                               "dtype or decay) after the sharded "
                               "optimizer's first step")
        self._build(self._values(), sync=False)

    def split_by(self, key_fn) -> None:
        """Make every flat hold one value of ``key_fn(param)`` (the
        sharded optimizer's decay groups) as ``flat.key[2]``."""
        self._key_fn = key_fn
        keys = [{key_fn(p) for p in f.params} for f in self.buckets]
        if any(len(k) > 1 for k in keys):
            self._relayout()
            return
        for f, (k,) in zip(self.buckets, keys):
            f.key = f.key[:2] + (k,)

    def sync_layout(self) -> None:
        """Rebuild the flats if a parameter's dtype changed
        (``amp.decorate`` after wrapping casts the empty parameter; the
        shard is cast with it)."""
        if any(p.dtype != f.dtype for f in self.buckets for p in f.params):
            self._relayout()

    # -- gather / free ---------------------------------------------------
    def gather(self, seg: _Segment) -> None:
        if seg.gathered:
            return
        from .communication.collective_ops import _collective_entry
        pg = self.group.process_group
        for f in seg.flats:
            full = torch.empty(f.numel, dtype=f.dtype, device=f.device)
            _collective_entry("all_gather", self.group, tensor=f.param_shard)
            all_gather_single(full, f.param_shard, group=pg)
            self.gathers += 1
            f.view(full)
        seg.gathered = True

    @staticmethod
    def free(seg: _Segment) -> None:
        for f in seg.flats:
            f.release()
        seg.gathered = False

    def gather_all(self) -> None:
        for seg in self.segments:
            self.gather(seg)

    def release(self) -> None:
        """Free every gathered segment (the parameters back to empty)."""
        for seg in self.segments:
            if seg.gathered:
                self.free(seg)

    def begin_forward(self) -> None:
        root = self._by_name.get("root")
        if root is not None:
            self.gather(root)

    def end_forward(self, out) -> None:
        """The root stays gathered for the backward when one can follow
        (freed by its reduce-scatter), else it is freed now."""
        root = self._by_name.get("root")
        if root is not None and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in _tensors(out))):
            self.free(root)

    def _pre_forward(self, name: str) -> None:
        self.gather(self._by_name[name])

    def _post_forward(self, name: str, out) -> None:
        if torch._C._current_graph_task_id() != -1:
            return                    # a recomputation inside the backward
        seg = self._by_name[name]
        if torch.is_grad_enabled():
            for t in _tensors(out):
                if t.requires_grad:
                    t.register_hook(lambda g, name=name: self.gather(
                        self._by_name[name]))
        self.free(seg)

    # -- backward --------------------------------------------------------
    def _on_grad(self, p) -> None:
        if not self._armed:
            self._armed = True
            self._next = 0
            for seg in self.segments:
                seg.pending = {id(q) for f in seg.flats for q in f.params}
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finalize)
        seg = self._seg_of[id(p)]
        seg.pending.discard(id(p))
        if not seg.pending:
            self._launch_ready()

    def _launch_ready(self) -> None:
        while self._next < len(self._order) and \
                not self._order[self._next].pending:
            self._reduce_scatter(self._order[self._next])
            self._next += 1

    def _reduce_scatter(self, seg: _Segment) -> None:
        from .communication.collective_ops import _collective_entry
        self._retire()
        pg = self.group.process_group
        for f in seg.flats:
            g = torch.zeros(f.numel, dtype=f.dtype, device=f.device)
            for p, off in zip(f.params, f.offsets):
                if p.grad is not None:
                    g[off:off + p.grad.numel()].copy_(p.grad.reshape(-1))
                p.grad = None
            n = f.hi - f.lo
            if f.shard_grad is None:
                f.shard_grad = torch.empty(n, dtype=f.dtype, device=f.device)
            f.grad_add = torch.empty_like(f.shard_grad) if f.has_grad \
                else None
            _collective_entry("reduce_scatter", self.group, tensor=g,
                              reduce_op=ReduceOp.AVG)
            f.work = reduce_scatter_single(
                f.grad_add if f.grad_add is not None else f.shard_grad, g,
                op=dist.ReduceOp.AVG, group=pg, async_op=True)
            f.grad_full = g
            self.reduce_scatters += 1
        seg.pending = set()
        self.free(seg)
        self._inflight.append(seg)

    def _retire(self) -> None:
        """Wait on the reduce-scatters in flight and drop their full
        gradients (on the card the compute stream waits on NCCL's)."""
        for seg in self._inflight:
            for f in seg.flats:
                f.work.wait()
                if f.grad_add is not None:
                    f.shard_grad.add_(f.grad_add)
                f.has_grad = True
                f.work = f.grad_full = f.grad_add = None
        self._inflight = []

    def _finalize(self) -> None:
        self._armed = False
        for seg in self._order[self._next:]:
            seg.pending = set()       # unused in this backward: zeros
        self._launch_ready()
        self._retire()
        self.release()

    def clear(self) -> None:
        """Drop the averaged gradients (the optimizer's ``clear_grad``)."""
        for f in self.buckets:
            f.has_grad = False

    def _checkpoint_pieces(self, keyed) -> list:
        """``distributed.checkpoint``'s pieces of the parameters of
        ``keyed`` (``(key, parameter)``): each parameter's slot of its
        flat cut to this rank's ``[lo, hi)``, a flat range of the
        parameter, viewing ``param_shard`` (a load writes there)."""
        from .checkpoint.pieces import piece
        where = {}
        for f in self.buckets:
            for p, off, shape in zip(f.params, f.offsets, f.shapes):
                where[id(p)] = (f, off, shape)
        out = []
        for key, p in keyed:
            f, off, shape = where[id(p)]
            a, e = max(off, f.lo), min(off + shape.numel(), f.hi)
            if a < e:
                out.append(piece(key, f.param_shard[a - f.lo:e - f.lo],
                                 shape, shape, 0,
                                 [((0,) * len(shape), tuple(shape))],
                                 a - off, e - off))
        return out


class DataParallel(torch.nn.Module):
    """ref: ``python/paddle/distributed/parallel.py`` DataParallel: the
    reference's parameters in its order.  ``comm_buffer_size`` and
    ``last_comm_buffer_size`` are bucket sizes in MB (module
    docstring); ``group`` defaults to every rank (under a fleet topology
    with an expert degree above 1, to its dp x sharding group: the ranks
    of an ep group hold different experts, which a broadcast over the
    world would overwrite); ``strategy`` is accepted and read by
    nothing, as in the reference.  Gradients of
    parameters unused in a backward are averaged as zeros whatever
    ``find_unused_parameters`` says (every rank then steps the same
    parameters).  Requires ``init_parallel_env`` first."""

    def __init__(self, layers: torch.nn.Module, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        self._layers = layers
        if group is None:
            from .fleet.base.topology import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
            if hcg is not None and hcg.get_expert_parallel_world_size() > 1:
                group = hcg.get_dp_sharding_parallel_group()
        self._group = _resolve_group(group)
        self.find_unused_parameters = find_unused_parameters
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        self._reducer = _Reducer(layers.parameters(), self._group,
                                 comm_buffer_size * _MB,
                                 last_comm_buffer_size * _MB)
        _mark_checkpoint_owner(layers)
        self._sync_params_buffers()

    @torch.no_grad()
    def _sync_params_buffers(self) -> None:
        """The group's first rank's parameters and buffers on every rank,
        as upstream's DataParallel does when it is built."""
        from .communication.collective_ops import broadcast
        src = self._group.ranks[0]
        for b in self._reducer.buckets:
            broadcast(b.param_buf, src=src, group=self._group)
        for t in self._layers.buffers():
            broadcast(t, src=src, group=self._group)

    def forward(self, *inputs, **kwargs):
        self._reducer.sync_layout()
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Backward inside leaves the gradients local (accumulating);
        the first backward outside averages them (ref:
        ``DataParallel.no_sync``)."""
        old = self._reducer.sync_enabled
        self._reducer.sync_enabled = False
        try:
            yield
        finally:
            self._reducer.sync_enabled = old

    def scale_loss(self, loss):
        """The loss unchanged: the reducer averages the gradients."""
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


# ---------------------------------------------------------------------------
# spawn
# ---------------------------------------------------------------------------

def _spawn_entry(index: int, func, args, env: Dict[str, str]) -> None:
    os.environ.update(env[index])
    func(*args)


def spawn(func, args=(), nprocs: int = -1, join: bool = True, daemon=False,
          **options):
    """ref: ``paddle.distributed.spawn``: start ``nprocs`` processes
    (``-1``: one per visible card), each with the launcher's environment
    for its rank, and call ``func(*args)`` in each; ``func`` calls
    ``init_parallel_env`` itself, rank r on card r.  The option
    ``backend="gloo"`` lets ``nprocs`` run without a card, for
    ``init_parallel_env(device="cpu")``; other options raise
    ``NotImplementedError``.  Returns torch's process context (``join``
    it with a timeout when ``join=False``)."""
    import torch.multiprocessing as mp
    unknown = sorted(set(options) - {"backend"})
    if unknown:
        raise NotImplementedError(f"spawn options {unknown}")
    if nprocs == -1:
        nprocs = torch.cuda.device_count()
        if nprocs < 1:
            raise RuntimeError("spawn(nprocs=-1) found no CUDA card; pass "
                               "nprocs with backend='gloo'")
    store = serve_store(nprocs)
    env = [{"PADDLE_TRAINER_ID": str(r), "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_MASTER": f"127.0.0.1:{store.port}",
            STORE_SERVED_ENV: "1", "PADDLE_RANK_IN_NODE": str(r),
            "FLAGS_selected_gpus": str(r)} for r in range(nprocs)]
    ctx = mp.start_processes(_spawn_entry, args=(func, tuple(args), env),
                             nprocs=nprocs, join=join, daemon=daemon,
                             start_method="spawn")
    if ctx is not None:
        ctx.store = store            # served while the ranks may run
    return ctx
