"""HybridParallelOptimizer and DygraphShardingOptimizer; counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer/
hybrid_parallel_optimizer.py``.

The JAX package marks the optimizer's state for a sharded layout and
lets XLA place it.  Here :class:`DygraphShardingOptimizer` shards the
state itself (ZeRO stages 1 and 2) over the flat buckets of the model's
DataParallel reducer (``parallel._Reducer``):

* rank r of a sharding group of n holds, for each bucket, the fp32
  master (for bf16/fp16 parameters under ``multi_precision``), the fp32
  ``moment1``/``moment2`` and the bias-correction powers of elements
  ``[r*N/n, (r+1)*N/n)`` only;
* after backward it updates that shard with one launch of the fused
  AdamW kernel (K3, ``ops.fused_adamw``) per bucket, reading the shard of
  the averaged gradient (stage 1: the all-reduced bucket; stage 2: the
  reducer's reduce-scattered ``shard_grad``) and writing the master and
  the bucket's parameter shard;
* an all-gather over the group then refreshes every rank's parameters,
  which are views of the bucket.

Under ZeRO stage 3 (``GroupShardedStage3``: the reducer's ``mode`` is
``"stage3"``) the "buckets" are the segment flats of
``parallel._ShardedReducer``: K3 updates each flat's shard (its
``param_shard`` and the averaged ``shard_grad``) and nothing is gathered
after the step; the next forward gathers the segments it runs.

A ``grad_clip`` on the inner optimizer runs after the gradient
reductions below.  The global-norm clip sums each rank's share of the
squared norm over the mp, pp and sharding groups (``nn.clip``); under
:class:`DygraphShardingOptimizer` the share is the rank's gradient
shards (stage 1: its slice of the all-reduced bucket; stages 2 and 3:
the reduce-scattered ``shard_grad``), summed over the sharding group,
and the clip's scale is multiplied into each bucket's shard before K3
(one multiply a bucket).  ``ClipGradByValue`` clamps the shards;
``ClipGradByNorm``, a per-tensor norm, runs on the whole gradients under
stage 1 and raises ``NotImplementedError`` under stages 2 and 3, whose
ranks hold no whole gradient.

``amp.GradScaler`` unscales what a rank steps (``_unscale_targets``: the
gradients, or the sharded optimizer's shards, after the reductions,
which then do not run again at the step) and, on a step it skips, calls
``_skip_step``: no K3, no beta-power advance, and under stage 3 the
shards stay as they were.

Weight decay, the clip class (split over mp, whole, or not clipped)
must be uniform within a bucket: the buckets are split by each
parameter's decay (``apply_decay_param_fun``) and clip class when the
optimizer is built.  ``lr_ratio`` raises ``NotImplementedError``.

A tensor-parallel model (mp, sep or cp above 1: ``TensorParallel``) is
not in a ``DataParallel`` unless the sharding degree is above 1, so
:meth:`HybridParallelOptimizer.step` first reduces its gradients, as
Paddle's does with ``fused_allreduce_gradients``: averaged over dp and
summed over sep / cp (whose ranks hold replicated parameters and see
different tokens of the same rows); under a sharding reducer, which
averages over dp x sharding, only the sep / cp sum is left.

Under a pipeline degree above 1 the optimizer holds the rank's own
stage's parameters (``PipelineLayer`` builds no other; the pipeline
steps hand it the rank's blocks and tails), and :meth:`step` first sums
each shared weight's gradient over the stages that hold it and averages
every gradient over the stage's dp group, once, after the last
micro-batch's backward (``pipeline_allreduce_gradients``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch

from .....nn.clip import (ClipGradByGlobalNorm, ClipGradByValue, _sq_sum,
                          need_clip)
from .....ops.fused_adamw import fused_adamw_update_
from .....optimizer.optimizers import Adam, AdamW
from ....communication.collective_ops import _collective_entry
from ....communication.group import _resolve_group
from ....parallel import (_remember_checkpoint_owner, all_gather_single,
                          reducer_of)
from ...base.topology import get_hybrid_communicate_group

__all__ = ["HybridParallelOptimizer", "DygraphShardingOptimizer"]


def _clip_class(p) -> str:
    """How the global-norm clip counts ``p`` (a bucket holds one class):
    ``"split"`` over mp, ``"whole"``, or ``"none"`` (not clipped)."""
    from ...meta_parallel.parallel_layers.mp_layers import is_split
    if not need_clip(p):
        return "none"
    h = get_hybrid_communicate_group()
    if h is not None and h.get_model_parallel_world_size() > 1 \
            and is_split(p):
        return "split"
    return "whole"


def _decay_of(opt, p) -> float:
    """The decoupled weight decay ``opt`` applies to ``p``."""
    if not isinstance(opt, AdamW):
        return 0.0
    fun = opt._apply_decay_param_fun
    if fun is not None and not fun(getattr(p, "name", None)):
        return 0.0
    return opt._wd


class DygraphShardingOptimizer:
    """ref: ``dygraph_sharding_optimizer.py`` — ZeRO: each rank of the
    sharding group owns 1/n of the optimizer state (module docstring).
    Build it after the model is wrapped (``fleet.distributed_model``,
    ``DataParallel`` or ``group_sharded_parallel``), whose reducer holds
    the buckets; ``hcg`` (default: fleet's) gives the sharding group."""

    def __init__(self, optimizer, hcg=None):
        hcg = hcg or get_hybrid_communicate_group()
        group = hcg.get_sharding_parallel_group() if hcg is not None \
            else None
        self._setup(optimizer, _resolve_group(group))

    @classmethod
    def over(cls, optimizer, group) -> "DygraphShardingOptimizer":
        """The sharding optimizer over an explicit ``group``."""
        self = cls.__new__(cls)
        self._setup(optimizer, group)
        return self

    def _setup(self, optimizer, group) -> None:
        if not isinstance(optimizer, Adam):
            raise NotImplementedError(
                f"sharding {type(optimizer).__name__}: the sharded update "
                "is the fused AdamW kernel (Adam or AdamW)")
        if getattr(optimizer, "_lr_ratio", None) is not None:
            raise NotImplementedError("lr_ratio under sharding waits for a "
                                      "later slice")
        self._inner_opt = optimizer
        self._group = group
        params = [p for g in optimizer.param_groups for p in g["params"]]
        reducers = {id(reducer_of(p)) for p in params}
        reducer = reducer_of(params[0]) if params else None
        if reducer is None or len(reducers) != 1:
            raise ValueError("wrap the model first (fleet.distributed_model, "
                             "DataParallel or group_sharded_parallel): the "
                             "sharded optimizer updates its reducer's "
                             "buckets")
        if len(params) != len(reducer.params):
            raise ValueError("the optimizer must hold every trainable "
                             "parameter of the wrapped model")
        clip = getattr(optimizer, "_grad_clip", None)
        if clip is not None and reducer.mode != "all_reduce" and \
                not isinstance(clip, (ClipGradByGlobalNorm,
                                      ClipGradByValue)):
            raise NotImplementedError(
                f"grad_clip {type(clip).__name__} under sharding stage 2 or "
                "3: a per-tensor norm needs whole gradients, and a rank "
                "holds its shard")
        self._reducer = reducer
        reducer.split_by(lambda p: (_decay_of(optimizer, p), _clip_class(p)))
        self._nranks = group.nranks
        self._rank = group.rank
        for b in reducer.buckets:
            if b.numel % self._nranks:
                raise ValueError(f"a bucket of {b.numel} elements does not "
                                 f"split over {self._nranks} ranks")
        if reducer.mode in ("reduce_scatter", "stage3") and \
                reducer.group.ranks != group.ranks:
            raise ValueError("stages 2 and 3 shard over the reducer's own "
                             "group")
        # bucket index -> {"m", "v", "pows", "master"} of this rank's shard
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}

    def _shard(self, b):
        n = b.numel // self._nranks
        return self._rank * n, (self._rank + 1) * n

    def _param_shard(self, b) -> torch.Tensor:
        """This rank's shard of bucket (or stage-3 flat) ``b``'s values."""
        if self._reducer.mode == "stage3":
            return b.param_shard
        lo, hi = self._shard(b)
        return b.param_buf[lo:hi]

    def _new_state(self, b) -> Dict[str, torch.Tensor]:
        dev = b.device
        n = b.numel // self._nranks
        st = {"m": torch.zeros(n, dtype=torch.float32, device=dev),
              "pows": torch.ones(2, dtype=torch.float32, device=dev)}
        st["v"] = torch.zeros_like(st["m"])
        if self._inner_opt._use_master(b.params[0]):
            st["master"] = self._param_shard(b).float()
        if self._reducer.mode == "stage3":
            self._reducer.frozen = True      # the layout is fixed now
        return st

    def _ready(self):
        """The buckets (index, bucket) that hold gradients this step."""
        stage3 = self._reducer.mode == "stage3"
        return [(k, b) for k, b in enumerate(self._reducer.buckets)
                if (b.has_grad if stage3 else
                    any(p.grad is not None for p in b.params))]

    def _grad_shard(self, b) -> torch.Tensor:
        """This rank's shard of bucket ``b``'s averaged gradient."""
        if self._reducer.mode == "all_reduce":
            lo, hi = self._shard(b)
            return b.grad_buf[lo:hi]
        return b.shard_grad

    def _unscale_targets(self):
        """The gradient shards this rank steps (``amp.GradScaler``)."""
        return [self._grad_shard(b) for _, b in self._ready()]

    def _flag_group(self):
        """The sharding group: its ranks hold different shards."""
        return self._group

    def _skip_step(self) -> None:
        """A step ``amp.GradScaler`` skips: nothing moves."""
        if self._reducer.mode == "stage3":
            self._reducer.release()

    def _norm_group(self):
        """The group the global norm's shard sums are summed over: the
        sharding group, with the mp and pp ranks when they split the
        model."""
        h = get_hybrid_communicate_group()
        if h is not None and max(h.get_model_parallel_world_size(),
                                 h.get_pipe_parallel_world_size()) > 1:
            if self._group.ranks != h.get_sharding_parallel_group().ranks:
                raise NotImplementedError(
                    "a global-norm clip over a sharding group other than "
                    "the topology's under mp or pp")
            return h._global_norm_group()
        return self._group

    def _clip(self, ready):
        """Apply the inner optimizer's clip to the shards of ``ready``;
        returns the global norm's scale (None for other clips)."""
        clip = self._inner_opt._grad_clip
        if clip is None:
            return None
        if isinstance(clip, ClipGradByGlobalNorm):
            h = get_hybrid_communicate_group()
            mp_rank = h.get_model_parallel_rank() if h is not None else 0
            local = _sq_sum([self._grad_shard(b) for _, b in ready
                             if b.key[2][1] == "split"
                             or (b.key[2][1] == "whole" and mp_rank == 0)])
            dev = ready[0][1].device if ready else \
                self._reducer.buckets[0].device
            sq = clip._reduced_sq(local, self._norm_group(), dev)
            return None if sq is None else clip._scale_of(sq)
        if isinstance(clip, ClipGradByValue):
            for _, b in ready:
                if b.key[2][1] != "none":
                    self._grad_shard(b).clamp_(clip.min, clip.max)
            return None
        # stage 1: the whole averaged gradients, which the buckets view
        params = [p for _, b in ready for p in b.params
                  if p.grad is not None]
        for p, g in zip(params, clip([(p, p.grad) for p in params])):
            p.grad.copy_(g[1])
        return None

    @torch.no_grad()
    def step(self):
        opt = self._inner_opt
        pg = self._group.process_group
        stage3 = self._reducer.mode == "stage3"
        ready = self._ready()
        scale = self._clip(ready)
        works = []
        for k, b in ready:
            st = self._state.get(k)
            if st is None:
                st = self._state[k] = self._new_state(b)
            betas = opt._betas.get(b.device)
            if betas is None:
                betas = torch.tensor([opt._beta1, opt._beta2],
                                     dtype=torch.float32, device=b.device)
                opt._betas[b.device] = betas
            st["pows"].mul_(betas)
            p_shard = self._param_shard(b)
            g_shard = self._grad_shard(b)
            if scale is not None and b.key[2][1] != "none":
                g_shard.mul_(scale.to(g_shard.dtype))
            master = st.get("master")
            fused_adamw_update_(
                master if master is not None else p_shard, g_shard,
                st["m"], st["v"], opt._lr_on(b.device), st["pows"][0:1],
                st["pows"][1:2], opt._beta1, opt._beta2, opt._epsilon,
                b.key[2][0], p_low=p_shard if master is not None else None)
            if stage3:
                continue             # the next forward gathers
            _collective_entry("all_gather", self._group, tensor=p_shard)
            works.append(all_gather_single(b.param_buf, p_shard, group=pg,
                                           async_op=True))
        for w in works:
            w.wait()
        if stage3:
            self._reducer.release()
        opt._global_step += 1

    def clear_grad(self, set_to_zero: bool = True):
        self._inner_opt.clear_grad(set_to_zero=set_to_zero)
        if self._reducer.mode == "stage3":
            self._reducer.clear()

    clear_gradients = clear_grad

    # -- state: full values per parameter, as the unsharded optimizer's --
    def _gather(self, shard: torch.Tensor, numel: int) -> torch.Tensor:
        full = torch.empty(numel, dtype=shard.dtype, device=shard.device)
        all_gather_single(full, shard.contiguous(),
                          group=self._group.process_group)
        return full

    def state_dict(self):
        """The inner optimizer's ``state_dict`` format with every
        parameter's full state, gathered from the shards now (a
        collective call: every rank of the sharding group makes it).
        The dict is remembered as this optimizer's, so
        ``distributed.checkpoint`` saves and loads the live shards, not
        these copies (``Optimizer.state_dict``)."""
        opt = self._inner_opt
        params = [p for g in opt.param_groups for p in g["params"]]
        index = {id(p): i for i, p in enumerate(params)}
        state = {}
        for k, b in enumerate(self._reducer.buckets):
            st = self._state.get(k)
            if st is None:
                continue
            full = {name: self._gather(st[key], b.numel)
                    for name, key in (("moment1", "m"), ("moment2", "v"),
                                      ("master", "master")) if key in st}
            shapes = b.shapes if self._reducer.mode == "stage3" else \
                [p.shape for p in b.params]     # stage 3: empty params
            for p, off, shape in zip(b.params, b.offsets, shapes):
                entry = {name: t[off:off + shape.numel()].view(shape).clone()
                         for name, t in full.items()}
                entry["beta_pows"] = st["pows"].clone()
                state[index[id(p)]] = entry
        sd = OrderedDict(state=state,
                         param_groups=opt.state_dict()["param_groups"])
        _remember_checkpoint_owner(sd, "", self)
        return sd

    def set_state_dict(self, state_dict):
        """Load an unsharded ``state_dict`` (this optimizer's or the inner
        optimizer's format): each rank keeps its shards."""
        opt = self._inner_opt
        params = [p for g in opt.param_groups for p in g["params"]]
        index = {id(p): i for i, p in enumerate(params)}
        saved = state_dict["state"]
        self._state = {}
        for k, b in enumerate(self._reducer.buckets):
            entries = [(p, off, saved.get(index[id(p)]))
                       for p, off in zip(b.params, b.offsets)]
            if all(e is None for _, _, e in entries):
                continue
            lo, hi = self._shard(b)
            st = self._new_state(b)
            for name, key in (("moment1", "m"), ("moment2", "v"),
                              ("master", "master")):
                if key not in st:
                    continue
                full = torch.zeros(b.numel, dtype=torch.float32,
                                   device=b.device)
                for p, off, e in entries:
                    if e is not None:
                        full[off:off + e[name].numel()] = \
                            e[name].reshape(-1)
                st[key] = full[lo:hi].clone()
            pows = next(e["beta_pows"] for _, _, e in entries
                        if e is not None)
            st["pows"] = pows.to(device=b.device, dtype=torch.float32).clone()
            self._state[k] = st

    def _checkpoint_pieces(self, prefix: str, names, create: bool = False):
        """``(pieces, values)`` for ``distributed.checkpoint``: the
        inner optimizer's keys (``Optimizer._checkpoint_pieces``), each
        parameter's accumulators cut to the part of its slot inside this
        rank's shard of its bucket (a flat range of the parameter), its
        bucket's powers whole.  ``create`` makes every bucket's state
        first (a load into a fresh optimizer)."""
        from .....optimizer.optimizer import _name_of, _pow_pieces
        from ....checkpoint.pieces import piece
        from ...meta_parallel.parallel_layers.mp_layers import (
            _checkpoint_layout)
        stage3 = self._reducer.mode == "stage3"
        buckets = self._reducer.buckets
        if create:
            for k, b in enumerate(buckets):
                if k not in self._state:
                    self._state[k] = self._new_state(b)
        pieces = []
        for k, b in enumerate(buckets):
            st = self._state.get(k)
            if st is None:
                continue
            lo, hi = self._shard(b)
            shapes = b.shapes if stage3 else [p.shape for p in b.params]
            for p, off, shape in zip(b.params, b.offsets, shapes):
                name = _name_of(names, p)
                gshape, axis, boxes = _checkpoint_layout(p, shape)
                a, e = max(off, lo), min(off + shape.numel(), hi)
                if a < e:
                    for skey, ckey in (("m", f"{name}_moment1"),
                                       ("v", f"{name}_moment2"),
                                       ("master", f"master_weights.{name}")):
                        if skey in st:
                            pieces.append(piece(
                                prefix + ckey, st[skey][a - lo:e - lo],
                                shape, gshape, axis, boxes, a - off, e - off))
                pieces += _pow_pieces(prefix, name, st["pows"], piece)
        return pieces, {prefix + "global_step":
                        self._inner_opt._global_step}

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)


class HybridParallelOptimizer:
    """ref: ``hybrid_parallel_optimizer.py`` HybridParallelOptimizer:
    the inner optimizer's step, sharded (ZeRO stage 1) when the
    topology's sharding degree is above 1.  Gradients are averaged by the
    model's DataParallel reducer before ``step``."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy
        self._sharding: Optional[DygraphShardingOptimizer] = None
        self._grads_reduced = False
        if self._hcg is not None and \
                self._hcg.get_sharding_parallel_world_size() > 1:
            self._sharding = DygraphShardingOptimizer(optimizer, self._hcg)

    @property
    def _learning_rate(self):
        return self._inner_opt._learning_rate

    def _stepper(self):
        return self._sharding if self._sharding is not None \
            else self._inner_opt

    def _tensor_parallel(self) -> bool:
        h = self._hcg
        return h is not None and max(
            h.get_model_parallel_world_size(),
            h.get_sep_parallel_world_size(),
            h.get_context_parallel_world_size()) > 1

    def _pipeline(self) -> bool:
        h = self._hcg
        return h is not None and h.get_pipe_parallel_world_size() > 1

    def _reduce_gradients(self):
        """A pipeline stage's or a tensor-parallel model's gradient
        reduction (module docstring); nothing otherwise."""
        if self._pipeline():
            from ...utils.hybrid_parallel_util import (
                pipeline_allreduce_gradients)
            pipeline_allreduce_gradients(
                [p for g in self._inner_opt.param_groups
                 for p in g["params"]], self._hcg)
            return
        if not self._tensor_parallel():
            return
        from ...utils.hybrid_parallel_util import (
            fused_allreduce_gradients, _sequence_allreduce_gradients)
        h = self._hcg
        params = [p for g in self._inner_opt.param_groups
                  for p in g["params"] if p.grad is not None]
        if not params:
            return
        seq = h.get_sep_parallel_world_size() * \
            h.get_context_parallel_world_size()
        if reducer_of(params[0]) is None:
            if h.get_data_parallel_world_size() * seq > 1:
                fused_allreduce_gradients(params, h)
        elif seq > 1:
            _sequence_allreduce_gradients(
                params, h.mesh.group(("sep", "cp"), name="sep_cp"), scale=1.0)

    def _reduce_once(self) -> None:
        """The step's gradient reduction, once (``amp.GradScaler``
        unscales after it, then steps)."""
        if not self._grads_reduced:
            self._reduce_gradients()
            self._grads_reduced = True

    def _unscale_targets(self):
        self._reduce_once()
        return self._stepper()._unscale_targets()

    def _flag_group(self):
        return self._stepper()._flag_group()

    def _skip_step(self) -> None:
        self._grads_reduced = False
        if self._sharding is not None:
            self._sharding._skip_step()

    def step(self):
        self._reduce_once()
        self._stepper().step()
        self._grads_reduced = False

    def clear_grad(self, set_to_zero: bool = True):
        self._grads_reduced = False
        self._inner_opt.clear_grad(set_to_zero=set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()

    def state_dict(self):
        return self._stepper().state_dict()

    def set_state_dict(self, sd):
        if self._sharding is not None:
            return self._sharding.set_state_dict(sd)
        return self._inner_opt.load_state_dict(sd)

    def get_lr(self):
        return self._inner_opt.get_lr()

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)
