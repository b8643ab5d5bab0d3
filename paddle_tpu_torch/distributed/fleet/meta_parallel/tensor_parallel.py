"""The tensor-parallel model wrappers; counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py`` (ref:
``fleet/meta_parallel/tensor_parallel.py``, ``segment_parallel.py``).

The JAX package's parameters are born global, so its wrap is a marker.
Here each rank built its own model, so :class:`TensorParallel`
broadcasts at wrap time (Paddle's ``_prepare_for_model``): the
parameters replicated across the mp group from its first rank (the
shards stay), then everything across the sep, cp, sharding and dp
groups, whose ranks share their mp coordinate.  A TensorParallel model
is not wrapped in ``DataParallel``: ``HybridParallelOptimizer.step``
reduces its gradients over dp (and sums them over sep / cp).  With a
sharding degree above 1 the layers go into a ``DataParallel`` over the
dp x sharding group, whose buckets ZeRO stage 1 shards.
"""
from __future__ import annotations

import torch

from ...parallel import DataParallel
from ..base.topology import get_hybrid_communicate_group
from ..utils.hybrid_parallel_util import (broadcast_cp_parameters,
                                          broadcast_dp_parameters,
                                          broadcast_mp_parameters,
                                          broadcast_sep_parameters,
                                          broadcast_sharding_parameters)

__all__ = ["MetaParallelBase", "TensorParallel", "SegmentParallel"]


class MetaParallelBase(torch.nn.Module):
    """ref: ``MetaParallelBase``: holds ``_layers`` and forwards to it."""

    def __init__(self, layers: torch.nn.Module, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


class TensorParallel(MetaParallelBase):
    """ref: ``TensorParallel`` (module docstring)."""

    @torch.no_grad()
    def _prepare_for_model(self):
        hcg = self._hcg
        broadcast_mp_parameters(self._layers, hcg)
        broadcast_sep_parameters(self._layers, hcg)
        broadcast_cp_parameters(self._layers, hcg)
        broadcast_sharding_parameters(self._layers, hcg)
        broadcast_dp_parameters(self._layers, hcg)
        if hcg.get_sharding_parallel_world_size() > 1:
            self._layers = DataParallel(
                self._layers, group=hcg.get_dp_sharding_parallel_group())


class SegmentParallel(TensorParallel):
    """ref: ``SegmentParallel``: the sep-axis wrapper; attention does the
    all-to-all (``segment_parallel``)."""
