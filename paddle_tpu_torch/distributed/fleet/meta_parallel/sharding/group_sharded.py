"""ZeRO group sharding, stages 1 and 2; counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding/group_sharded.py``.

The JAX package records the stage and lets GSPMD lay the state out.
Here the stages run on the DataParallel reducer's flat buckets (see
``parallel.py``) and ``DygraphShardingOptimizer``:

* ``"os"`` (stage 1): the model is wrapped in ``DataParallel``, each
  bucket is all-reduced (averaged) and each rank updates its shard of the
  optimizer state;
* ``"os_g"`` (stage 2): :class:`GroupShardedStage2` reduce-scatters each
  bucket instead, so each rank receives only its shard of the averaged
  gradient.

In both, each rank holds the fp32 master, ``moment1`` and ``moment2`` of
its shard only, K3 updates each shard (one launch per bucket), and an
all-gather refreshes the bf16 parameters, which are views of the
buckets: every rank's model holds full parameters after each step, so
``state_dict`` on the wrapper returns full values, as the reference's
does.  ``"p_g_os"`` (stage 3, parameters sharded between steps) waits
for the next distributed slice and raises ``NotImplementedError``.
"""
from __future__ import annotations

import os

import torch

from ....communication.collective_ops import broadcast
from ....communication.group import _resolve_group
from ....parallel import DataParallel
from ...base.topology import get_hybrid_communicate_group
from ...meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer import (
    DygraphShardingOptimizer)

__all__ = ["GroupShardedStage2", "group_sharded_parallel",
           "save_group_sharded_model"]


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


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None):
    """ref: ``distributed/sharding/group_sharded.py``
    group_sharded_parallel.  ``level``: ``"os"`` (stage 1) or ``"os_g"``
    (stage 2); returns ``(model, optimizer, scaler)`` with the model
    wrapped and the optimizer sharded over ``group`` (default: fleet's
    sharding group, else every rank).  ``"p_g_os"``, ``scaler``,
    ``offload``, ``sync_comm``, ``dp_group``, ``exclude_layer`` and
    non-default buffer or segment sizes raise ``NotImplementedError``."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError("level must be one of 'os', 'os_g', 'p_g_os'")
    if level == "p_g_os":
        raise NotImplementedError("stage 3 ('p_g_os', parameters sharded "
                                  "between steps) waits for the next "
                                  "distributed slice")
    for what, given in (("scaler", scaler is not None), ("offload", offload),
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
    else:
        model = GroupShardedStage2(model, optimizer, group=group,
                                   sync_buffers=sync_buffers)
    return model, DygraphShardingOptimizer.over(optimizer, group), scaler


def save_group_sharded_model(model, output, optimizer=None):
    """ref: ``save_group_sharded_model``: the wrapped model's full
    weights (``model.pdmodel``) and the optimizer's gathered state
    (``model.pdopt``) under ``output``, written by the group's first
    rank.  Every rank makes the call (gathering the state is
    collective)."""
    opt_state = optimizer.state_dict() if optimizer is not None else None
    g = getattr(model, "_group", None)
    if g is not None and g.rank != 0:
        return
    os.makedirs(output, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(output, "model.pdmodel"))
    if opt_state is not None:
        torch.save(opt_state, os.path.join(output, "model.pdopt"))
