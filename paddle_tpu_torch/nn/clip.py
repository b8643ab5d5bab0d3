"""Gradient clipping; counterpart of ``paddle_tpu/nn/clip.py`` (ref:
``python/paddle/nn/clip.py``).

:class:`ClipGradByValue`, :class:`ClipGradByNorm` and
:class:`ClipGradByGlobalNorm` take ``[(param, grad)]`` and return it
clipped, as the JAX classes do; the port's optimizers call them once a
step, just before the update (``grad_clip=``).  A parameter whose
``need_clip`` is False (``ParamAttr(need_clip=False)``) passes
unclipped and, under the global norm, uncounted.  Norms are taken in
fp32; a scale is cast to each gradient's dtype before the product.

**The global norm from shards.**  The JAX package's arrays are global,
so its norm is global by construction.  Here a rank holds a part of the
parameters or of their gradients, so :class:`ClipGradByGlobalNorm`
builds the global squared sum from this rank's share, after the hybrid
optimizer's gradient reductions:

* a parameter split over mp (``mp_layers.is_split``) counts on every mp
  rank (each holds its own shard); a replicated one counts on mp rank 0
  only (its gradient is equal on every mp rank: the SP hooks and the sep
  / cp sums have run);
* a weight several pipeline stages share (``pp_shared_group``, its
  gradient already summed over them) counts on its first stage only;
* the shares are summed by **one** fp32 all-reduce over the group of the
  mp, pp and sharding axes (``HybridCommunicateGroup._global_norm_group``);
  the dp, sep and cp ranks hold equal gradients and are not summed over;
* under ZeRO the sharded optimizer (``DygraphShardingOptimizer``) counts
  each rank's gradient shard instead of whole gradients
  (:meth:`ClipGradByGlobalNorm._reduced_sq` over its own group).

``last_norm`` and ``last_local_norm`` keep the last step's global norm
and this rank's own share of it (device scalars, read by tests and
``chip_smoke.py``; reading one is a host read).  Under an expert degree
the experts' sums are added over the ep group by
:class:`~..incubate.distributed.models.moe.ClipGradForMOEByGlobalNorm`;
this class refuses expert parameters there.

:class:`ClipGradByNorm` is a per-tensor norm: under mp a split
parameter's squares are summed over the mp group (one all-reduce for
all of them).  :func:`clip_grad_norm_` and :func:`clip_grad_value_` are
``paddle.nn.utils``'s, on the gradients this process holds.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def need_clip(p) -> bool:
    """Whether ``p``'s gradient is clipped (``ParamAttr.need_clip``)."""
    return getattr(p, "need_clip", True) is not False


def _sq_norms(grads: List[torch.Tensor]) -> torch.Tensor:
    """Each gradient's sum of squares in fp32, as one vector: on the card
    one multi-tensor norm launch (its reductions are trees); on the CPU
    a sum a tensor (``vector_norm`` there accumulates in order and drifts
    by ~1e-6 over a few 1e5 elements, the pairwise ``sum`` does not)."""
    if grads[0].is_cuda:
        return torch.stack(torch._foreach_norm(
            grads, 2, dtype=torch.float32)).square()
    return torch.stack([g.float().square().sum() for g in grads])


def _sq_sum(grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """The sum of every gradient's squares in fp32 (None for none)."""
    if not grads:
        return None
    return _sq_norms(grads).sum()


def _mul_(grads: List[torch.Tensor], scale: torch.Tensor) -> None:
    """Each gradient times ``scale`` cast to its dtype, in place."""
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for dtype, gs in by_dtype.items():
        torch._foreach_mul_(gs, scale.to(dtype))


def _hcg():
    from ..distributed.fleet.base.topology import (
        get_hybrid_communicate_group)
    return get_hybrid_communicate_group()


def _all_reduce_sum(t: torch.Tensor, group) -> None:
    from ..distributed.communication.collective_ops import all_reduce
    all_reduce(t, group=group)


class ClipGradBase:
    def __call__(self, params_grads: List[Tuple[torch.Tensor,
                                                torch.Tensor]]):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        return [(p, g if g is None or not need_clip(p)
                 else g.clamp(self.min, self.max)) for p, g in params_grads]

    def __str__(self):
        return f"ClipGradByValue(min={self.min}, max={self.max})"


class ClipGradByNorm(ClipGradBase):
    """Each gradient times ``min(clip_norm / max(norm, 1e-12), 1)``, its
    own fp32 norm; under mp a split parameter's norm is its whole
    tensor's (module docstring)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers \
            import is_split
        todo = [(i, p, g) for i, (p, g) in enumerate(params_grads)
                if g is not None and need_clip(p)]
        if not todo:
            return list(params_grads)
        sq = _sq_norms([g for _, _, g in todo])
        h = _hcg()
        if h is not None and h.get_model_parallel_world_size() > 1:
            split = torch.tensor([is_split(p) for _, p, _ in todo],
                                 device=sq.device)
            part = torch.where(split, sq, torch.zeros_like(sq))
            _all_reduce_sum(part, h.get_model_parallel_group())
            sq = torch.where(split, part, sq)
        norm = sq.sqrt()
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        out = list(params_grads)
        for k, (i, p, g) in enumerate(todo):
            out[i] = (p, g * scale[k].to(g.dtype))
        return out

    def __str__(self):
        return f"ClipGradByNorm(clip_norm={self.clip_norm})"


class ClipGradByGlobalNorm(ClipGradBase):
    """The reference's parameters in its order.  ``group_name`` is a
    label and ``auto_skip_clip`` is kept and read by nothing, as in the
    JAX package."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip
        self.last_norm: Optional[torch.Tensor] = None
        self.last_local_norm: Optional[torch.Tensor] = None

    def _counted(self, params_grads) -> List[torch.Tensor]:
        """The gradients of this rank's share of the global norm (module
        docstring)."""
        from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers \
            import is_split
        from ..distributed.fleet.utils.hybrid_parallel_util import (
            counts_shared_weight)
        h = _hcg()
        mp_rank = h.get_model_parallel_rank() if h is not None else 0
        return [g for p, g in params_grads
                if g is not None and need_clip(p)
                and (mp_rank == 0 or is_split(p))
                and counts_shared_weight(p, h)]

    def _local_sq(self, params_grads) -> Optional[torch.Tensor]:
        """This rank's share of the squared global norm in fp32."""
        from ..incubate.distributed.models.moe.moe_layer import (
            is_expert_param)
        h = _hcg()
        if h is not None and h.get_expert_parallel_world_size() > 1 \
                and any(is_expert_param(p)
                        for p, g in params_grads if g is not None):
            raise NotImplementedError(
                "ClipGradByGlobalNorm over expert parameters under an "
                "expert degree above 1 misses the other ranks' experts; "
                "use ClipGradForMOEByGlobalNorm")
        return _sq_sum(self._counted(params_grads))

    def _reduced_sq(self, local: Optional[torch.Tensor], group,
                    device=None) -> Optional[torch.Tensor]:
        """``local`` summed over ``group`` (one fp32 all-reduce; a rank
        without gradients adds 0), kept as ``last_local_norm`` /
        ``last_norm``."""
        many = group is not None and group.nranks > 1
        if local is None:
            if not many:
                return None
            from ..device import default_device
            local = torch.zeros((), dtype=torch.float32,
                                device=default_device(device))
        total = local
        if many:
            total = local.clone()
            _all_reduce_sum(total, group)
        self.last_local_norm = local.sqrt()
        self.last_norm = total.sqrt()
        return total

    def _squared_norm(self, params_grads, device=None
                      ) -> Optional[torch.Tensor]:
        """The squared global norm of the gradients in fp32."""
        h = _hcg()
        group = h._global_norm_group() if h is not None else None
        return self._reduced_sq(self._local_sq(params_grads), group, device)

    def _scale_of(self, sq: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(sq)
        return self.clip_norm / torch.clamp(norm, min=self.clip_norm)

    def scale(self, params_grads, device=None) -> Optional[torch.Tensor]:
        """``clip_norm / max(global_norm, clip_norm)`` as an fp32 device
        scalar (None when no rank has a gradient to count)."""
        sq = self._squared_norm(params_grads, device)
        return None if sq is None else self._scale_of(sq)

    def _dygraph_clip(self, params_grads, device=None):
        s = self.scale(params_grads, device)
        if s is None:
            return list(params_grads)
        return [(p, g if g is None or not need_clip(p)
                 else g * s.to(g.dtype)) for p, g in params_grads]

    def _clip_(self, params_grads, device=None) -> None:
        """:meth:`_dygraph_clip` in place, the optimizers' form: one
        multi-tensor multiply a dtype (every rank joins the norm's
        collective, gradients or not: ``device`` is where it sums)."""
        s = self.scale(params_grads, device)
        if s is not None:
            _mul_([g for p, g in params_grads
                   if g is not None and need_clip(p)], s)

    def __str__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"


def _as_list(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """``paddle.nn.utils.clip_grad_norm_``: the ``norm_type`` norm over
    every gradient (fp32 sums; ``inf``: the largest magnitude), each
    gradient times ``min(max_norm / (total + 1e-6), 1)`` in place;
    returns the total.  ``error_if_nonfinite`` is kept and read by
    nothing, as in the JAX package."""
    params = _as_list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum().pow(1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """``paddle.nn.utils.clip_grad_value_``: every gradient into
    ``[-clip_value, clip_value]`` in place."""
    for p in _as_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
