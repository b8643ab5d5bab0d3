"""Weight carry-over from a ``paddle_tpu`` model.

The caller turns the JAX model's ``state_dict()`` into plain numpy
arrays (``{name: np.asarray(t._data)}``) on its side; this module never
imports the JAX package.  A model in a ``DataParallel``, tensor-parallel
or group-sharded wrapper is unwrapped (``_layers``) first, so the names
are the bare model's.  Names and ``[in, out]`` shapes are the same in
both packages, so the copy needs no transposes.  A model built under
model parallelism takes its rank's shard of each split parameter
(``split_axis`` cut into ``split_groups`` contiguous
groups, each split over the mp ranks; GPT's packed qkv keeps its heads of
each of q, k and v), as it would have drawn them.  The JAX package
carries weights before ``amp.decorate`` casts them; a model already
decorated takes them too, each value rounded to its parameter's dtype.

Under an expert degree each rank's MoE layers hold experts ``ep_rank *
E / ep`` to ``(ep_rank + 1) * E / ep - 1`` under their global indices
(``...ffn.experts.{e}...``): a rank takes those and leaves the other
experts' arrays, and any other mismatch raises.

One pipeline stage (:func:`load_stage_state`) takes the arrays of the
parameters it holds and leaves the others, which are other stages': a
``PipelineLayer`` registers its layers under their global index, as the
JAX package's does, and a model trained by a pipeline step holds its own
blocks (the others are placeholders without parameters), so the names
are the JAX model's and the segmentation is the same on both sides.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    is_split, shard_of)

__all__ = ["load_paddle_tpu_state", "load_stage_state"]


def load_paddle_tpu_state(model: torch.nn.Module,
                          arrays: Mapping[str, np.ndarray]) -> None:
    """Fill ``model``'s parameters from the global ``arrays``, each cast
    to its parameter's dtype; split parameters take this rank's shard by
    the fleet topology's mp coordinates (one rank without a topology).
    Raises unless the names match both ways and every shard's shape is
    equal."""
    while hasattr(model, "_layers"):
        model = model._layers
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params) - _other_experts(model, arrays))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, "
                       f"unexpected {extra}")
    _fill(params, arrays)


def _other_experts(model, arrays) -> set:
    """The names in ``arrays`` of experts another ep rank holds."""
    from ..incubate.distributed.models.moe import MoELayer
    out = set()
    for prefix, m in model.named_modules():
        if not isinstance(m, MoELayer):
            continue
        held = set(m.experts.indices())
        head = f"{prefix}.experts." if prefix else "experts."
        for name in arrays:
            if name.startswith(head):
                e = name[len(head):].split(".", 1)[0]
                if e.isdigit() and int(e) not in held \
                        and int(e) < m.num_expert:
                    out.add(name)
    return out


def load_stage_state(model: torch.nn.Module,
                     arrays: Mapping[str, np.ndarray]) -> None:
    """Fill the parameters this pipeline stage holds from the global
    ``arrays`` (split ones as :func:`load_paddle_tpu_state` does); the
    arrays of parameters it does not hold are other stages' and stay
    unread.  Raises unless every held parameter has its array."""
    while hasattr(model, "_layers"):
        model = model._layers
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    if missing:
        raise KeyError(f"state mismatch: missing {missing}")
    _fill(params, arrays)


def _fill(params, arrays) -> None:
    from ..distributed.fleet.base.topology import (
        get_hybrid_communicate_group)
    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg else 0
    mp_degree = hcg.get_model_parallel_world_size() if hcg else 1
    for name, p in params.items():
        a = torch.tensor(np.asarray(arrays[name]))
        if is_split(p):
            a = shard_of(a, p.split_axis, p.split_groups, mp_rank,
                         mp_degree)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(a)
