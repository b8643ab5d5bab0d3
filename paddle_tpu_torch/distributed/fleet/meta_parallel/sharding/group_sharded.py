"""ZeRO group sharding, stages 1 to 3; counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding/group_sharded.py``.

The JAX package records the stage and lets GSPMD lay the state out.
Here the stages run on the port's own reducers (``parallel.py``) and
``DygraphShardingOptimizer``:

* ``"os"`` (stage 1): the model is wrapped in ``DataParallel``, each
  bucket is all-reduced (averaged) and each rank updates its shard of the
  optimizer state;
* ``"os_g"`` (stage 2): :class:`GroupShardedStage2` reduce-scatters each
  bucket instead, so each rank receives only its shard of the averaged
  gradient;
* ``"p_g_os"`` (stage 3): :class:`GroupShardedStage3` shards the
  parameters too (``parallel._ShardedReducer``): between steps each rank
  holds its shard of every segment's flat (a layer of the model's
  ``ModuleList``, or the root: embeddings, final norm, head), the
  forward and the backward gather a segment while it runs, and its
  gradients are reduce-scattered once they are complete.

In stages 1 and 2 each rank holds the fp32 master, ``moment1`` and
``moment2`` of its shard only, K3 updates each shard (one launch per
bucket), and an all-gather refreshes the bf16 parameters, which are views
of the buckets: every rank's model holds full parameters after each step,
so ``state_dict`` on the wrapper returns full values, as the reference's
does.  In stage 3, K3 updates each segment flat's shard and nothing is
gathered after the step: the next forward gathers.
"""
from __future__ import annotations

import os

import torch

from ....communication.collective_ops import broadcast
from ....communication.group import _resolve_group
from .....framework.io import save
from ....parallel import (DataParallel, _ShardedReducer,
                          _mark_checkpoint_owner)
from ...base.topology import get_hybrid_communicate_group
from ...meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer import (
    DygraphShardingOptimizer)

__all__ = ["GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "save_group_sharded_model"]


def _sharding_group(group):
    """``group``, else the topology's sharding group when fleet runs one
    of more than one rank, else every rank."""
    if group is not None:
        return _resolve_group(group)
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        return hcg.get_sharding_parallel_group()
    return _resolve_group(None)


class GroupShardedStage2(DataParallel):
    """ref: ``sharding/group_sharded_stage2.py``: the model with its
    gradients reduce-scattered over ``group`` (module docstring).
    ``sync_buffers`` broadcasts the model's buffers from the group's
    first rank before each forward.  ``buffer_max_size`` other than the
    default, ``dp_group`` and a ``device`` other than the card raise
    ``NotImplementedError``; the buckets are DataParallel's (25 MB)."""

    def __init__(self, layer, sharding_optimizer=None, group=None,
                 sync_buffers: bool = False, buffer_max_size: int = 2 ** 23,
                 auto_refresh_trainable: bool = True, device: str = "gpu",
                 dp_group=None):
        if buffer_max_size != 2 ** 23:
            raise NotImplementedError("buffer_max_size: the buckets are "
                                      "DataParallel's comm_buffer_size")
        if dp_group is not None:
            raise NotImplementedError("dp_group (sharding inside data "
                                      "parallel) waits for a later slice")
        if device not in ("gpu", "cpu"):
            raise NotImplementedError(f"device {device!r}")
        super().__init__(layer, group=_sharding_group(group))
        self._sync_buffers = sync_buffers
        self._reducer.set_mode("reduce_scatter")
        self._sharding_optimizer = sharding_optimizer

    def forward(self, *inputs, **kwargs):
        if self._sync_buffers:
            for b in self._layers.buffers():
                broadcast(b, src=self._group.ranks[0], group=self._group)
        return super().forward(*inputs, **kwargs)


class GroupShardedStage3(torch.nn.Module):
    """ref: ``sharding/group_sharded_stage3.py``: the model with its
    parameters, gradients and optimizer state sharded over ``group``
    (default: fleet's sharding group, else every rank), gathered by
    segment while they run (``parallel._ShardedReducer``).

    **What a parameter holds.**  Between steps every trainable parameter
    of the model is an empty tensor of its dtype and device (shape
    ``[0]``); this rank's values live in the reducer's flat shards.  A
    segment's parameters hold their full values (views of a gathered
    flat) only while it runs in the forward or the backward.  So read
    the weights through :meth:`state_dict` or :meth:`get_all_parameters`
    (both collective: every rank calls them), not ``parameters()``.

    ``pertrain_sync_models`` broadcasts the group's first rank's weights
    when the wrapper is built; ``sync_buffers`` broadcasts the buffers
    before each forward.  ``optimizer`` is accepted and read by nothing
    (build the sharded optimizer after wrapping, as
    ``group_sharded_parallel`` does).  ``offload``, ``sync_comm``,
    ``dp_group``, ``exclude_layer``, a ``segment_size`` other than the
    default and a ``device`` other than the card or the CPU raise
    ``NotImplementedError``; the reference's default ``device`` names
    its own card, the port's the CUDA card.  A model split by model
    parallelism (mp above 1) raises ``NotImplementedError`` too: its
    segment flats would mix shards and replicated parameters."""

    def __init__(self, layer, optimizer=None, group=None,
                 sync_buffers: bool = False, device: str = "gpu",
                 segment_size: int = 2 ** 20,
                 pertrain_sync_models: bool = True, offload: bool = False,
                 sync_comm: bool = False, dp_group=None,
                 exclude_layer=None):
        super().__init__()
        for what, given in (("offload", offload), ("sync_comm", sync_comm),
                            ("dp_group", dp_group is not None),
                            ("exclude_layer", exclude_layer is not None),
                            ("segment_size", segment_size != 2 ** 20),
                            ("device", device not in ("gpu", "cpu"))):
            if given:
                raise NotImplementedError(f"GroupShardedStage3 {what}")
        from ..parallel_layers.mp_layers import is_split
        from ..parallel_layers.mp_ops import mp_group
        mp = mp_group(None)
        if mp is not None and mp.nranks > 1 and any(
                is_split(p) for p in layer.parameters()):
            raise NotImplementedError("GroupShardedStage3 of a model split "
                                      "by model parallelism waits for a "
                                      "later slice")
        self._layers = layer
        self._group = _sharding_group(group)
        self._sync_buffers = sync_buffers
        self._reducer = _ShardedReducer(layer, self._group,
                                        sync=pertrain_sync_models)
        _mark_checkpoint_owner(layer)
        if pertrain_sync_models:
            for b in layer.buffers():
                broadcast(b, src=self._group.ranks[0], group=self._group)

    def forward(self, *inputs, **kwargs):
        if self._sync_buffers:
            for b in self._layers.buffers():
                broadcast(b, src=self._group.ranks[0], group=self._group)
        red = self._reducer
        red.sync_layout()
        red.begin_forward()
        out = self._layers(*inputs, **kwargs)
        red.end_forward(out)
        return out

    def get_all_parameters(self, convert2cpu: bool = False):
        """Every parameter of the model with its full value, on every rank
        (a collective call).  The parameters stay full until the next
        forward or optimizer step; with ``convert2cpu`` the call returns
        host copies instead and the parameters are freed again."""
        red = self._reducer
        red.gather_all()
        if not convert2cpu:
            return list(self._layers.parameters())
        out = [p.detach().cpu() for p in self._layers.parameters()]
        red.release()
        return out

    def state_dict(self, *args, **kwargs):
        """The full weights on every rank (a collective call): each
        segment is gathered, copied and freed."""
        red = self._reducer
        red.gather_all()
        try:
            return {k: v.detach().clone() if isinstance(v, torch.Tensor)
                    else v for k, v in
                    self._layers.state_dict(*args, **kwargs).items()}
        finally:
            red.release()

    def set_state_dict(self, state_dict, *args, **kwargs):
        """Load full weights (a collective call): each rank keeps its
        shards."""
        red = self._reducer
        red.gather_all()
        try:
            out = self._layers.load_state_dict(state_dict, *args, **kwargs)
            for f in red.buckets:
                f.param_shard.copy_(f.full[f.lo:f.hi])
        finally:
            red.release()
        return out

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None):
    """ref: ``distributed/sharding/group_sharded.py``
    group_sharded_parallel.  ``level``: ``"os"`` (stage 1), ``"os_g"``
    (stage 2) or ``"p_g_os"`` (stage 3); returns ``(model, optimizer,
    scaler)`` with the model wrapped and the optimizer sharded over
    ``group`` (default: fleet's sharding group, else every rank).
    ``scaler`` (``amp.GradScaler``) is returned as given: it unscales
    and checks the sharded optimizer's gradient shards.  ``offload``,
    ``sync_comm``, ``dp_group``, ``exclude_layer`` and non-default
    buffer or segment sizes raise ``NotImplementedError``."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError("level must be one of 'os', 'os_g', 'p_g_os'")
    for what, given in (("offload", offload),
                        ("sync_comm", sync_comm),
                        ("dp_group", dp_group is not None),
                        ("exclude_layer", exclude_layer is not None),
                        ("segment_size", segment_size != 2 ** 20),
                        ("buffer_max_size", buffer_max_size != 2 ** 23)):
        if given:
            raise NotImplementedError(f"group_sharded_parallel {what}")
    group = _sharding_group(group)
    if level == "os":
        model = DataParallel(model, group=group)
    elif level == "os_g":
        model = GroupShardedStage2(model, optimizer, group=group,
                                   sync_buffers=sync_buffers)
    else:
        model = GroupShardedStage3(model, optimizer, group=group,
                                   sync_buffers=sync_buffers)
    return model, DygraphShardingOptimizer.over(optimizer, group), scaler


def save_group_sharded_model(model, output, optimizer=None):
    """ref: ``save_group_sharded_model``: the wrapped model's full
    weights (``model.pdmodel``) and the optimizer's gathered state
    (``model.pdopt``) under ``output`` through ``paddle.save``
    (``framework.io.save``; read them back with ``paddle_tpu_torch.
    load``), written by the group's first rank.  Every rank makes the
    call (gathering the weights under stage 3 and the optimizer's state
    is collective)."""
    model_state = model.state_dict()
    opt_state = optimizer.state_dict() if optimizer is not None else None
    g = getattr(model, "_group", None)
    if g is not None and g.rank != 0:
        return
    os.makedirs(output, exist_ok=True)
    save(model_state, os.path.join(output, "model.pdmodel"))
    if opt_state is not None:
        save(opt_state, os.path.join(output, "model.pdopt"))
