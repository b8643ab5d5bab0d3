"""Gradient clipping by the global norm; counterpart of
``paddle_tpu/nn/clip.py`` (ref: ``python/paddle/nn/clip.py``).

:class:`ClipGradByGlobalNorm` scales every gradient by ``clip_norm /
max(global_norm, clip_norm)``, the norm taken in fp32 over every
gradient, the scale cast to each gradient's dtype before the product, as
the JAX class does.  The port's optimizers honour it (``grad_clip=``):
each step computes the scale once (:meth:`ClipGradByGlobalNorm.scale`)
and multiplies each gradient just before its update.

Under a live expert-parallel group the ranks of an ep group hold
different experts, so a rank's own sum of squares misses the others'
experts.  :class:`~..incubate.distributed.models.moe.
ClipGradForMOEByGlobalNorm` adds the experts' partial sums over that
group; this class refuses expert parameters there
(``NotImplementedError``).  Under a fleet topology with mp, pp,
sharding, sep or cp above 1 a rank holds a part of the parameters or of
their gradients, so both classes raise ``NotImplementedError`` when
they compute the norm: those groups' partial sums wait for a later
slice.  The other clip classes of the reference wait for a later slice
too.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm"]


def _sq_sum(grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """The sum of every gradient's squares in fp32 (None for none)."""
    if not grads:
        return None
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]
    return torch.stack(norms).square().sum()


class ClipGradBase:
    def __call__(self, params_grads: List[Tuple[torch.Tensor,
                                                torch.Tensor]]):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """The reference's parameters in its order.  ``group_name`` is a
    label and ``auto_skip_clip`` is kept and read by nothing, as in the
    JAX package."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def _squared_norm(self, params_grads) -> Optional[torch.Tensor]:
        """The squared global norm of the gradients in fp32."""
        from ..distributed.fleet.base.topology import (
            get_hybrid_communicate_group)
        from ..incubate.distributed.models.moe.moe_layer import (
            is_expert_param)
        hcg = get_hybrid_communicate_group()
        if hcg is not None and hcg.get_expert_parallel_world_size() > 1 \
                and any(is_expert_param(p)
                        for p, g in params_grads if g is not None):
            raise NotImplementedError(
                "ClipGradByGlobalNorm over expert parameters under an "
                "expert degree above 1 misses the other ranks' experts; "
                "use ClipGradForMOEByGlobalNorm")
        return _sq_sum([g for _, g in params_grads if g is not None])

    @staticmethod
    def _check_layout() -> None:
        """Raise under a fleet topology whose groups split the parameters
        or their gradients (mp, pp, sharding, sep or cp above 1)."""
        from ..distributed.fleet.base.topology import (
            get_hybrid_communicate_group)
        h = get_hybrid_communicate_group()
        if h is not None and max(
                h.get_model_parallel_world_size(),
                h.get_pipe_parallel_world_size(),
                h.get_sharding_parallel_world_size(),
                h.get_sep_parallel_world_size(),
                h.get_context_parallel_world_size()) > 1:
            raise NotImplementedError(
                "grad_clip under mp, pp, sharding, sep or cp waits for a "
                "later slice (the norm's partial sums over those groups); "
                "it runs under dp and ep")

    def scale(self, params_grads) -> Optional[torch.Tensor]:
        """``clip_norm / max(global_norm, clip_norm)`` as an fp32 device
        scalar (None when no gradient is given)."""
        self._check_layout()
        sq = self._squared_norm(params_grads)
        if sq is None:
            return None
        norm = torch.sqrt(sq)
        return self.clip_norm / torch.clamp(norm, min=self.clip_norm)

    def _dygraph_clip(self, params_grads):
        s = self.scale(params_grads)
        if s is None:
            return params_grads
        return [(p, g if g is None else g * s.to(g.dtype))
                for p, g in params_grads]

    def __str__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"
